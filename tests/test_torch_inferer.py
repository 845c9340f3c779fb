"""The port's inference path (yolov6_tpu_torch/core/inferer.py, tools/infer.py,
hub.py, utils/draw.py, data/datasets.py::LoadData) against the JAX package's
(yolov6_tpu/core/inferer.py, hubconf.py), fp32 on the CPU, with the same
weights (``state_dict_from_jax``).

The source is a directory of the repository's three demo JPEGs and one PNG;
each package reads it with its own decoder (cv2 and the port's, bit-equal:
tests/test_torch_jpeg.py). The ``labels/*.txt`` rows are compared per image:
the same number of rows and classes; the normalised box within 1e-4 and the
score within 2e-5 (the rows carry 6 significant digits; the two packages'
convolutions round differently). Rows whose scores tie within that
tolerance have no order of their own and are matched as a set.
"""

import os
import re
import shutil

import cv2
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.core.inferer import Inferer as JaxInferer
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch import hub
from yolov6_tpu_torch.core.inferer import Inferer
from yolov6_tpu_torch.data.datasets import LoadData
from yolov6_tpu_torch.data.image_io import image_format, imread, imwrite_png
from yolov6_tpu_torch.tools import infer as infer_cli
from yolov6_tpu_torch.utils import draw, text
from yolov6_tpu_torch.utils.data_config import load_data_config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import N_CONFIG, REPO_ROOT, random_jax_variables

IMG = 160
NC = 4
NAMES = ["person", "traffic light", "car", "teddy bear"]
INFER = dict(conf_thres=0.3, iou_thres=0.45, max_det=1000)
BOX_TOL, SCORE_TOL = 1e-4, 2e-5
HUB_IMG = 96


def _small_n_config_file(path):
    """configs/yolov6n.py cut as tests/torch_port_utils.py::small_n_config
    does (depth 0.1, width 0.0625), written out: both inferers take a path."""
    with open(N_CONFIG) as f:
        src = f.read()
    src = re.sub(r"depth_multiple=[0-9.]+", "depth_multiple=0.1", src)
    src = re.sub(r"width_multiple=[0-9.]+", "width_multiple=0.0625", src)
    with open(path, "w") as f:
        f.write(src)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("inferer")
    src = root / "src"
    src.mkdir()
    for i in (1, 2, 3):
        shutil.copy(os.path.join(REPO_ROOT, "data", "images", f"image{i}.jpg"), src)
    rng = np.random.default_rng(3)
    png = cv2.GaussianBlur(rng.integers(0, 256, (150, 200, 3), dtype=np.uint8), (0, 0), 2)
    imwrite_png(str(src / "image4.png"), png)
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"nc: {NC}\nnames: {NAMES}\n")
    cfg_path = _small_n_config_file(root / "small_n.py")

    jmodel = jax_build_model(JaxConfig.fromfile(cfg_path), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=41)
    ckpt = jax_save_checkpoint({"model": variables}, False, str(root), "small_n")
    weights = str(root / "small_n.pt")
    torch.save(state_dict_from_jax(variables), weights)
    theirs = JaxInferer(str(src), False, "0", ckpt, cfg_path, str(yaml_path), IMG, False)
    ours = Inferer(str(src), False, "0", weights, cfg_path, str(yaml_path), IMG, False,
                   device="cpu")
    return dict(root=root, src=str(src), yaml=str(yaml_path), cfg=cfg_path, weights=weights,
                theirs=theirs, ours=ours)


def _rows(path):
    with open(path) as f:
        return [tuple(map(float, line.split())) for line in f.read().splitlines()]


def _assert_rows_equal(rows, rows_j):
    """Equal up to the order within runs of tied scores (module doc)."""
    assert len(rows) == len(rows_j)
    rows = sorted(rows, key=lambda r: -r[5])
    rows_j = sorted(rows_j, key=lambda r: -r[5])
    np.testing.assert_allclose([r[5] for r in rows], [r[5] for r in rows_j], rtol=0,
                               atol=SCORE_TOL)
    start = 0
    while start < len(rows):
        end = start + 1
        while end < len(rows) and rows_j[start][5] - rows_j[end][5] <= SCORE_TOL:
            end += 1
        todo = list(rows_j[start:end])
        for r in rows[start:end]:
            match = next((i for i, t in enumerate(todo) if r[0] == t[0] and np.allclose(
                r[1:5], t[1:5], rtol=0, atol=BOX_TOL)), None)
            assert match is not None, (r, rows_j[start:end])
            todo.pop(match)
        start = end


def _assert_outputs_equal(ours_dir, theirs_dir, with_images=True):
    """The same labels/*.txt rows in each output tree; the port's drawn
    images have the JAX inferer's names and formats (the source's own), at
    the source's size."""
    rel = "src"  # the rel_path rule puts a directory source's outputs under its name
    names = sorted(os.listdir(os.path.join(theirs_dir, rel, "labels")))
    assert names == ["image1.txt", "image2.txt", "image3.txt", "image4.txt"]
    assert sorted(os.listdir(os.path.join(ours_dir, rel, "labels"))) == names
    n_rows = 0
    for name in names:
        rows = _rows(os.path.join(ours_dir, rel, "labels", name))
        _assert_rows_equal(rows, _rows(os.path.join(theirs_dir, rel, "labels", name)))
        n_rows += len(rows)
        if with_images:
            stem = os.path.splitext(name)[0]
            ext = ".png" if stem == "image4" else ".jpg"
            src = imread(os.path.join(theirs_dir, rel, stem + ext))
            assert image_format(os.path.join(ours_dir, rel, stem + ext)) == (
                "png" if ext == ".png" else "jpeg")
            assert imread(os.path.join(ours_dir, rel, stem + ext)).shape == src.shape
    assert n_rows > 0
    return n_rows


def _run_both(setup, tmp_path, **kw):
    args = dict(INFER, classes=None, agnostic_nms=False, save_txt=True, save_img=True,
                hide_labels=False, hide_conf=False)
    args.update(kw)
    out, out_j = str(tmp_path / "ours"), str(tmp_path / "theirs")
    setup["ours"].infer(save_dir=out, **args)
    setup["theirs"].infer(save_dir=out_j, **args)
    return out, out_j


@pytest.mark.parametrize("variant", ["default", "classes", "agnostic"])
def test_inferer_matches_jax(setup, tmp_path, variant):
    """The default run, ``--classes 0 2`` and ``--agnostic-nms``."""
    kw = {"default": {}, "classes": dict(classes=[0, 2]),
          "agnostic": dict(agnostic_nms=True)}[variant]
    out, out_j = _run_both(setup, tmp_path, save_img=variant == "default", **kw)
    n = _assert_outputs_equal(out, out_j, with_images=variant == "default")
    if variant == "classes":
        for name in os.listdir(os.path.join(out, "src", "labels")):
            assert {r[0] for r in _rows(os.path.join(out, "src", "labels", name))} <= {0, 2}
    assert n >= 4


def test_cli_writes_the_same_files(setup, tmp_path):
    """``tools/infer.py``'s ``run`` over the same source writes the JAX
    inferer's label rows, and each drawn image under its source's name and
    format."""
    out_j = str(tmp_path / "theirs")
    setup["theirs"].infer(save_dir=out_j, classes=None, agnostic_nms=False, save_txt=True,
                          save_img=False, hide_labels=False, hide_conf=False, **INFER)
    out = str(tmp_path / "ours")
    args = infer_cli.get_args_parser().parse_args([
        "--weights", setup["weights"], "--config", setup["cfg"], "--source", setup["src"],
        "--yaml", setup["yaml"], "--img-size", str(IMG), "--conf-thres",
        str(INFER["conf_thres"]), "--save-txt", "--save-dir", out, "--device", "cpu"])
    assert args.max_det == INFER["max_det"] and args.iou_thres == INFER["iou_thres"]
    infer_cli.run(args)
    assert sorted(os.listdir(os.path.join(out, "src"))) == [
        "image1.jpg", "image2.jpg", "image3.jpg", "image4.png", "labels"]
    _assert_outputs_equal(out, out_j, with_images=False)
    for i in (1, 2, 3, 4):
        ext = "png" if i == 4 else "jpg"
        drawn = imread(os.path.join(out, "src", f"image{i}.{ext}"))
        assert drawn.shape == imread(os.path.join(setup["src"], f"image{i}.{ext}")).shape


def test_cli_needs_a_device_without_cuda(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = infer_cli.get_args_parser().parse_args([
        "--weights", setup["weights"], "--config", setup["cfg"], "--source", setup["src"],
        "--yaml", setup["yaml"], "--not-save-img"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer_cli.run(args)


def test_video_webcam_and_view_img_raise(setup, tmp_path):
    with pytest.raises(NotImplementedError, match="webcam"):
        LoadData("0", webcam=True)
    with pytest.raises(NotImplementedError, match="imshow"):
        setup["ours"].infer(save_dir=str(tmp_path / "v"), classes=None, agnostic_nms=False,
                            save_txt=False, save_img=False, hide_labels=False,
                            hide_conf=False, view_img=True, **INFER)
    loader = LoadData(os.path.join(setup["src"], "image1.jpg"))
    (img, path, cap), = list(loader)
    assert loader.type == "image" and cap is None and len(loader) == 1
    assert np.array_equal(img, cv2.imread(path))


def test_load_data_reads_a_video(setup, tmp_path):
    """A directory with an image and an mp4v clip written by cv2: the image,
    then the clip's frames as cv2.VideoCapture gives them."""
    shutil.copy(os.path.join(setup["src"], "image4.png"), tmp_path)
    clip = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 25, (96, 64))
    base = cv2.GaussianBlur(np.random.default_rng(5).integers(0, 256, (64, 96, 3), np.uint8),
                            (0, 0), 3)
    for i in range(5):
        writer.write(np.roll(base, 2 * i, axis=1))
    writer.release()
    loader = LoadData(str(tmp_path))
    items = list(loader)
    assert len(loader) == 2 and loader.type == "video" and len(items) == 6
    assert items[0][1].endswith("image4.png") and items[0][2] is None
    cap = cv2.VideoCapture(clip)
    for img, path, vcap in items[1:]:
        ok, frame = cap.read()
        assert ok and path == clip and vcap is not None
        assert np.array_equal(img, frame)


# ------------------------------------------------------------------ drawing

CONFS = (0.25, 0.5, 0.87, 1.0)


@pytest.mark.parametrize("lw", [2, 3, 4, 5, 6])
def test_get_text_size_equals_cv2(lw):
    """Every COCO name, with and without a confidence, at each lw's font
    scale and thickness as plot_box_and_label calls it, in both of its
    faces; and draw_text's: ((w, h), baseline) equal to cv2's."""
    names = load_data_config(os.path.join(REPO_ROOT, "data", "coco.yaml"))["names"]
    tf = max(lw - 1, 1)
    for i, name in enumerate(names):
        for label in (name, f"{name} {CONFS[i % len(CONFS)]:.2f}"):
            for face in (cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_COMPLEX):
                (w, h), base = cv2.getTextSize(label, face, fontScale=lw / 3, thickness=tf)
                assert text.get_text_size(label, face, lw / 3, tf) == ((w, h), base), (label, lw)
    want = cv2.getTextSize("FPS: 29.9", 0, 1.0, 2)
    assert text.get_text_size("FPS: 29.9", 0, 1.0, 2) == (tuple(want[0]), want[1])


def test_get_text_size_elsewhere():
    """At (scale, thickness) pairs plot_box_and_label does not use the size
    is cv2's too; so is a character of Rubik outside ASCII, and a control
    character, which both measure as '?'. A character outside Rubik (cv2
    draws it from its Unicode face) counts as '?' here."""
    for scale, tf in [(0.5, 1), (1.0, 1), (0.8, 2), (2.5, 3), (7.5, 8)]:
        for label in ("person 0.87", "traffic light 0.45", "FPS: 29.9", "caf\u00e9\t"):
            for face in (cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_COMPLEX):
                (w, h), base = cv2.getTextSize(label, face, scale, tf)
                assert text.get_text_size(label, face, scale, tf) == ((w, h), base), (label, scale)
    assert (text.get_text_size("caf\u00e9\t", 0, 1.0, 2)
            == text.get_text_size("caf\u00e9?", 0, 1.0, 2))
    assert text.get_text_size("a\u4eba", 0, 1.0, 2) == text.get_text_size("a?", 0, 1.0, 2)
    assert text.get_text_size("", 0, 1.0, 2) == ((0, 0), 0) == cv2.getTextSize("", 0, 1.0, 2)


DRAW_CASES = [((40, 60, 150, 130), 2, 0), ((5, 3, 90, 70), 3, 1), ((120, 90, 199, 149), 4, 2),
              ((30.7, 80.2, 61.9, 100.5), 5, 3), ((0, 0, 199, 149), 6, 0)]


@pytest.mark.parametrize("box,lw,cls", DRAW_CASES)
def test_plot_box_and_label_against_cv2(box, lw, cls):
    """The port's plot_box_and_label equals the JAX package's (cv2) on the
    same image, every pixel: the anti-aliased outline, the label's
    anti-aliased box and its text (measured with FONT_HERSHEY_SIMPLEX, drawn
    with FONT_HERSHEY_COMPLEX, as the JAX package does); and draw_text's FPS
    overlay."""
    rng = np.random.default_rng(lw)
    base = cv2.GaussianBlur(rng.integers(0, 256, (150, 200, 3), dtype=np.uint8), (0, 0), 2)
    label = f"{NAMES[cls]} 0.87"
    color = JaxInferer.generate_colors(cls, True)
    want, got = base.copy(), base.copy()
    JaxInferer.plot_box_and_label(want, lw, box, label, color=color)
    draw.plot_box_and_label(got, lw, box, label, color=color)
    assert (want != base).any()
    np.testing.assert_array_equal(got, want)
    kw = dict(pos=(20, 20), font_scale=lw / 4, text_color=(204, 85, 17),
              text_color_bg=(255, 255, 255), font_thickness=lw - 1)
    assert JaxInferer.draw_text(want, f"FPS: {lw * 7.3:0.1f}", **kw) == draw.draw_text(
        got, f"FPS: {lw * 7.3:0.1f}", **kw)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------- hub


def _load_hubconf():
    """THE REPO's hubconf by path (as tests/test_hubconf.py loads it)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "repo_hubconf", os.path.join(REPO_ROOT, "hubconf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hub_predict_matches_hubconf(setup, tmp_path):
    """``hub.yolov6n`` loads YOLOv6-N's weights from a state dict;
    ``hub.predict`` at its defaults but the size gives hubconf.predict's
    detections; the lite loaders build; visualize_detections writes the
    JPEG that cv2.imwrite writes."""
    hubconf = _load_hubconf()
    jmodel = jax_build_model(JaxConfig.fromfile(N_CONFIG), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HUB_IMG, HUB_IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=43)
    weights = str(tmp_path / "n.pt")
    torch.save(state_dict_from_jax(variables), weights)
    model = hub.yolov6n(weights=weights, num_classes=NC, device="cpu")
    img = imread(os.path.join(setup["src"], "image2.jpg"))
    dets = hub.predict(model, img, img_size=HUB_IMG)
    dets_j = hubconf.predict(jmodel, variables, img, img_size=HUB_IMG)
    assert dets.shape == dets_j.shape and len(dets) > 0
    np.testing.assert_array_equal(dets[:, 5], dets_j[:, 5])
    np.testing.assert_allclose(dets[:, 4], dets_j[:, 4], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(dets[:, :4], dets_j[:, :4], rtol=0, atol=2e-2)  # px
    path = os.path.join(setup["src"], "image2.jpg")
    np.testing.assert_array_equal(hub.predict(model, path, img_size=HUB_IMG), dets)

    out = hub.visualize_detections(path, dets, NAMES, str(tmp_path / "viz.jpg"))
    assert out.shape == img.shape and (out != img).any()
    with open(tmp_path / "viz.jpg", "rb") as f:
        assert f.read() == cv2.imencode(".jpg", out)[1].tobytes()
    for loader in (hub.yolov6lite_s, hub.yolov6lite_m, hub.yolov6lite_l):
        lite = loader(device="cpu")
        assert type(lite.detect).__name__ == "DetectLite" and lite.strides[-1] == 64
    seeded = hub.yolov6n(num_classes=NC, device="cpu")
    again = hub.yolov6n(num_classes=NC, device="cpu")
    for (k, a), b in zip(seeded.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
