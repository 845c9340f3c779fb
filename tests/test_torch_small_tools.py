"""The port's small tools against the JAX package's:
``data/voc2yolo.py`` (label files byte-equal on hand-written VOC XML),
``data/vis_dataset.py`` (pixels equal to the JAX tool's cv2 output outside
the text: the cv2 glyphs and the port's text boxes, dilated by 2 px) and
``utils/model_info.py`` (the deploy N and S graphs at 640 on ``meta``: the
parameter count equal to the JAX graph's, GFLOPs within 3% of BASELINE.md's
11.4G and 45.3G, and S's parameters, rounded to 0.1M, BASELINE.md's 18.5M;
N's 4.65M misses BASELINE.md's 4.7M at that rounding, so N's count is held
against the JAX graph's alone)."""

import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.data import vis_dataset as jax_vis
from yolov6_tpu.data import voc2yolo as jax_voc
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig
from yolov6_tpu.utils.model_info import count_params as jax_count_params

from yolov6_tpu_torch.data import vis_dataset, voc2yolo
from yolov6_tpu_torch.data.image_io import imread
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.data_config import load_data_config
from yolov6_tpu_torch.utils.draw import get_text_size
from yolov6_tpu_torch.utils.model_info import count_flops, count_params, get_model_info

from torch_port_utils import REPO_ROOT

XML = """<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>
{objects}</annotation>"""
OBJ = """<object><name>{name}</name><difficult>{difficult}</difficult><bndbox>
<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"""


def test_voc2yolo_labels_byte_equal(tmp_path):
    ann = tmp_path / "VOC" / "Annotations"
    ann.mkdir(parents=True)
    rng = np.random.default_rng(0)
    names = voc2yolo.VOC_NAMES + ["unicorn"]
    for i in range(5):
        objs = "".join(OBJ.format(name=names[int(rng.integers(0, len(names)))],
                                  difficult=int(rng.random() < 0.2),
                                  x1=f"{rng.uniform(0, 200):.1f}", y1=int(rng.integers(0, 150)),
                                  x2=f"{rng.uniform(200, 500):.2f}", y2=int(rng.integers(150, 375)))
                       for _ in range(i))  # the first file has no object
        (ann / f"{2008 + i:06d}.xml").write_text(XML.format(w=500, h=375, objects=objs))
    (ann / "notes.txt").write_text("not an annotation")
    out = {}
    for name, mod in (("ours", voc2yolo), ("theirs", jax_voc)):
        out[name] = tmp_path / name
        os.makedirs(out[name])
        for xml in sorted(os.listdir(ann)):
            if xml.endswith(".xml"):
                mod.convert_label(str(ann / xml), str(out[name] / xml.replace(".xml", ".txt")))
    voc2yolo.main(["--voc_path", str(tmp_path / "VOC"), "--out_dir", str(tmp_path / "cli")])
    files = sorted(os.listdir(out["theirs"]))
    assert len(files) == 5 and sorted(os.listdir(out["ours"])) == files
    assert sorted(os.listdir(tmp_path / "cli")) == files
    assert sum(len((out["theirs"] / f).read_bytes()) for f in files) > 0
    for f in files:
        want = (out["theirs"] / f).read_bytes()
        assert (out["ours"] / f).read_bytes() == want == (tmp_path / "cli" / f).read_bytes(), f


def test_vis_dataset_matches_jax(tmp_path, monkeypatch):
    data = load_data_config(generate_synth_dataset(str(tmp_path / "set"), n_train=0, n_val=4,
                                                   img_size=128, nc=4, seed=3))
    label_dir = data["val"].replace(osp.join("images", "val"), osp.join("labels", "val"))
    texts = []
    real_cv2, real_port = cv2.putText, vis_dataset.put_text

    def cv2_spy(img, text, org, font, scale, color, thickness=1, *a, **k):
        texts.append(("cv2", text, tuple(org), font, scale, thickness))
        return real_cv2(img, text, org, font, scale, color, thickness, *a, **k)

    def port_spy(img, text, org, scale, color, thickness):
        texts.append(("port", text, tuple(org), None, scale, thickness))
        return real_port(img, text, org, scale, color, thickness)

    monkeypatch.setattr(cv2, "putText", cv2_spy)
    monkeypatch.setattr(vis_dataset, "put_text", port_spy)
    jax_vis.visualize(data["val"], label_dir, str(tmp_path / "theirs"))
    written = vis_dataset.visualize(data["val"], label_dir, str(tmp_path / "ours"))
    assert len(written) == 4 and len(texts) > 8
    mask = np.zeros((128, 128), np.uint8)  # every image's texts, one mask
    for side, text, org, font, scale, thickness in texts:
        if side == "cv2":
            real_cv2(mask, text, org, font, scale, 255, thickness)
        else:
            w, h = get_text_size(text, scale, thickness)
            x, y = org
            mask[max(y - h, 0):y + 1, max(x, 0):max(x + w, 0)] = 255
    mask = cv2.dilate(mask, np.ones((5, 5), np.uint8)) > 0
    assert mask.mean() < 0.5
    for path in written:
        ours = imread(path)
        theirs = cv2.imread(str(tmp_path / "theirs" / osp.basename(path)))
        assert ours.shape == theirs.shape
        np.testing.assert_array_equal(ours[~mask], theirs[~mask])
        src = imread(osp.join(data["val"], osp.basename(path)))
        assert (ours != src).any()


BASELINE = {"n": (None, 11.4), "s": (18.5, 45.3)}  # params (M), GFLOPs at 640


@pytest.mark.parametrize("name", ["n", "s"])
def test_model_info_against_baseline(name):
    path = osp.join(REPO_ROOT, "configs", f"yolov6{name}.py")
    with torch.device("meta"):
        model = build_model(Config.fromfile(path), num_classes=80, deploy=True, device="meta")
    jax_model = jax_build_model(JaxConfig.fromfile(path), num_classes=80, deploy=True)
    spec = jax.eval_shape(lambda a: jax_model.init(jax.random.PRNGKey(0), a, train=False),
                          jnp.zeros((1, 64, 64, 3)))
    n_params = count_params(model)
    assert n_params == jax_count_params(spec)
    flops = count_flops(model, (640, 640))
    params_m, gflops = BASELINE[name]
    assert abs(flops / 1e9 - gflops) <= 0.03 * gflops, flops
    if params_m is not None:
        assert round(n_params / 1e6, 1) == params_m
    info = get_model_info(model, (640, 640))
    assert info == f"Params: {n_params / 1e6:.2f}M, GFLOPs: {flops / 1e9:.2f} @ 640x640"
