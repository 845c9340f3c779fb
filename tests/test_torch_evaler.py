"""The port's Evaler (yolov6_tpu_torch/core/evaler.py) against the JAX
package's Evaler on small S (no DFL; small M, with DFL, in
tests/test_torch_evaler_m.py), with the same weights (``state_dict_from_jax``),
fp32, on the CPU, at img 160, batch 4.

- On images whose long side is 160, no pixel is resized, so both packages
  see the same pixels from their own loaders; square and rect mode.
- On resized images (shrunk with INTER_AREA, enlarged with INTER_LINEAR),
  each package from its own loader: the port's resizers equal cv2's bit for
  bit (tests/test_torch_letterbox.py). The port's Evaler also runs on the
  JAX loader's batches, so that a difference of the model cannot hide
  behind a pixel.

Tolerances: the same number of COCO rows with the same image and category
ids in order; bbox within rtol 1e-4 / atol 2e-3 px (rows are rounded to
1e-3 px); score within 2e-5 (rounded to 1e-5); AP50 and AP within 1e-4.
Rows whose scores tie within the score tolerance have no order of their own
(anchors in the letterbox's grey border score alike to 1e-7, and the two
packages' convolutions round differently): within such a run the rows are
matched as a set.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.core.evaler import Evaler as JaxEvaler
from yolov6_tpu.core.evaler import decode_pred_rows as jax_decode_pred_rows
from yolov6_tpu.core.evaler import encode_pred_rows as jax_encode_pred_rows
from yolov6_tpu.data.data_load import create_dataloader as jax_create_dataloader
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.coco_eval import COCOEvaluator as JaxCOCOEvaluator
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.core.evaler import Evaler, decode_pred_rows, encode_pred_rows
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.layers.reparam import fold_to_deploy
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.tools import eval as eval_cli
from yolov6_tpu_torch.utils.checkpoint import load_state_dict_file
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.data_config import load_data_config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import (
    EVAL_IMG_SIZE, EVAL_SIZES, NATIVE_SIZES, REPO_ROOT, S_CONFIG, random_jax_variables,
    small_m_config, small_s_config,
)

NC, BATCH = 4, 4
BOX_TOL = dict(rtol=1e-4, atol=2e-3)
SCORE_TOL = dict(rtol=0, atol=2e-5)
AP_TOL = 1e-4
SMALL = {"s": small_s_config, "m": small_m_config}


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaler")
    native = load_data_config(generate_synth_dataset(
        str(root / "native"), n_train=0, n_val=8, img_size=EVAL_IMG_SIZE, seed=21,
        sizes=NATIVE_SIZES))
    resized = load_data_config(generate_synth_dataset(
        str(root / "resized"), n_train=0, n_val=7, img_size=EVAL_IMG_SIZE, seed=22,
        sizes=[s for s in EVAL_SIZES if max(s) != EVAL_IMG_SIZE]))
    return {"native": native, "resized": resized}


def load_models(name, sets, tmp_path_factory):
    """(JAX model, its JAX Evaler on the native set with the model's variables,
    the port's model with their weights). One JAX Evaler serves every test of
    a module, so that its batch function compiles once for each shape."""
    jmodel = jax_build_model(SMALL[name](JaxConfig), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, EVAL_IMG_SIZE, EVAL_IMG_SIZE, 3)), train=False))
    variables = random_jax_variables(shapes, seed=31)
    theirs = JaxEvaler(dict(sets["native"]), batch_size=BATCH, img_size=EVAL_IMG_SIZE,
                       half=False, save_dir=str(tmp_path_factory.mktemp("jax_evaler")))
    theirs.init_model(jmodel, variables)
    model = build_model(SMALL[name](Config), num_classes=NC, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, theirs, model


@pytest.fixture(scope="module")
def models(sets, tmp_path_factory):
    """Small S (no DFL); tests/test_torch_evaler_m.py runs these tests on small M."""
    return load_models("s", sets, tmp_path_factory)


def _evaler(data, tmp_path, **kw):
    return Evaler(dict(data), batch_size=BATCH, img_size=EVAL_IMG_SIZE, half=False,
                  save_dir=str(tmp_path), device="cpu", **kw)


def _close(a, b):
    return (a["image_id"] == b["image_id"] and a["category_id"] == b["category_id"]
            and np.allclose(a["bbox"], b["bbox"], **BOX_TOL)
            and abs(a["score"] - b["score"]) <= SCORE_TOL["atol"])


def _assert_rows_equal(rows, rows_j):
    """Equal in order, up to the order within runs of tied scores."""
    assert len(rows) == len(rows_j) > 0
    np.testing.assert_allclose([r["score"] for r in rows], [r["score"] for r in rows_j],
                               **SCORE_TOL)
    start = 0
    while start < len(rows):
        end = start + 1
        while (end < len(rows) and rows_j[end]["image_id"] == rows_j[start]["image_id"]
               and rows_j[start]["score"] - rows_j[end]["score"] <= SCORE_TOL["atol"]):
            end += 1
        todo = list(rows_j[start:end])
        for r in rows[start:end]:
            match = next((i for i, t in enumerate(todo) if _close(r, t)), None)
            assert match is not None, (r, rows_j[start:end])
            todo.pop(match)
        start = end


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_evaler_matches_jax_on_native_images(sets, models, tmp_path, rect):
    jmodel, theirs, model = models
    ours = _evaler(sets["native"], tmp_path, infer_on_rect=rect)
    ours.init_model(model)
    loader = ours.init_data(None, "val")
    # the JAX Evaler's own init_data with infer_on_rect (rect batches, pad 0.5);
    # the square pass also computes the PR metric (do_pr_metric)
    theirs.infer_on_rect = rect
    theirs.do_pr_metric = ours.do_pr_metric = not rect
    loader_j = theirs.init_data(None, "val")
    shapes = {tuple(b[0].shape[1:3]) for b in loader}
    assert (shapes != {(EVAL_IMG_SIZE, EVAL_IMG_SIZE)}) == rect
    rows = ours.predict_model(model, loader)
    rows_j = theirs.predict_model(jmodel, loader_j)
    _assert_rows_equal(rows, rows_j)
    ap, ap_j = ours.eval_model(rows, model, loader), theirs.eval_model(rows_j, jmodel, loader_j)
    np.testing.assert_allclose(ap, ap_j, rtol=0, atol=AP_TOL)
    assert 0 <= ap[1] <= ap[0] <= 1
    if not rect:
        assert ours.pr_results is not None
        np.testing.assert_allclose(ours.pr_results, theirs.pr_results, rtol=0, atol=AP_TOL)
    assert len(ours.batch_split) == len(loader) and ours.speed_result[0] == len(loader.dataset)


def test_evaler_matches_jax_on_the_jax_loaders_resized_batches(sets, models, tmp_path):
    jmodel, theirs, model = models
    theirs.do_pr_metric = False
    ours = _evaler(sets["resized"], tmp_path)
    ours.init_model(model)
    loader_j, dataset_j = jax_create_dataloader(
        sets["resized"]["val"], EVAL_IMG_SIZE, BATCH, data_dict=dict(sets["resized"]),
        task="val")
    rows_j = theirs.predict_model(jmodel, loader_j)
    rows = ours.predict_model(model, loader_j)
    _assert_rows_equal(rows, rows_j)
    ours.init_data(None, "val")  # writes the port's GT json, equal to the JAX one
    stats_j = JaxCOCOEvaluator(dataset_j.data_dict["anno_path"]).evaluate(rows_j)
    np.testing.assert_allclose(ours.eval_model(rows, model, None),
                               (stats_j["AP50"], stats_j["AP"]), rtol=0, atol=AP_TOL)


def test_evaler_matches_jax_on_resized_images(sets, models, tmp_path):
    """Each package's own loader over the resized set: the same pixels, so
    the same rows and AP."""
    jmodel, theirs, model = models
    theirs.infer_on_rect = theirs.do_pr_metric = False
    ours = _evaler(sets["resized"], tmp_path)
    ours.init_model(model)
    loader = ours.init_data(None, "val")
    loader_j, dataset_j = jax_create_dataloader(
        sets["resized"]["val"], EVAL_IMG_SIZE, BATCH, data_dict=dict(sets["resized"]),
        task="val")
    for (imgs, *_), (imgs_j, *_) in zip(loader, loader_j):
        np.testing.assert_array_equal(np.asarray(imgs), imgs_j)
    rows, rows_j = ours.predict_model(model, loader), theirs.predict_model(jmodel, loader_j)
    _assert_rows_equal(rows, rows_j)
    stats_j = JaxCOCOEvaluator(dataset_j.data_dict["anno_path"]).evaluate(rows_j)
    np.testing.assert_allclose(ours.eval_model(rows, model, loader),
                               (stats_j["AP50"], stats_j["AP"]), rtol=0, atol=AP_TOL)


@pytest.fixture(scope="module")
def jpeg_set(tmp_path_factory):
    """A native-size set written as JPEG: the generator's PNGs re-encoded by
    cv2 at quality 90 (4:2:0), the labels as generated."""
    root = tmp_path_factory.mktemp("evaler_jpeg")
    data = load_data_config(generate_synth_dataset(
        str(root), n_train=0, n_val=6, img_size=EVAL_IMG_SIZE, seed=24, sizes=NATIVE_SIZES))
    for name in os.listdir(data["val"]):
        png = os.path.join(data["val"], name)
        assert cv2.imwrite(png[:-4] + ".jpg", cv2.imread(png), [cv2.IMWRITE_JPEG_QUALITY, 90])
        os.unlink(png)
    return data


def test_evaler_matches_jax_on_a_jpeg_set(jpeg_set, models, tmp_path):
    """Each package's own loader over a JPEG set (cv2.imread against the
    port's decoder): the same pixels, so the same rows and AP."""
    jmodel, theirs, model = models
    theirs.infer_on_rect = theirs.do_pr_metric = False
    ours = _evaler(jpeg_set, tmp_path)
    ours.init_model(model)
    loader = ours.init_data(None, "val")
    loader_j, dataset_j = jax_create_dataloader(
        jpeg_set["val"], EVAL_IMG_SIZE, BATCH, data_dict=dict(jpeg_set), task="val")
    assert all(p.endswith(".jpg") for p in loader.dataset.img_paths)
    for (imgs, *_), (imgs_j, *_) in zip(loader, loader_j):
        np.testing.assert_array_equal(np.asarray(imgs), imgs_j)
    rows, rows_j = ours.predict_model(model, loader), theirs.predict_model(jmodel, loader_j)
    _assert_rows_equal(rows, rows_j)
    stats_j = JaxCOCOEvaluator(dataset_j.data_dict["anno_path"]).evaluate(rows_j)
    np.testing.assert_allclose(ours.eval_model(rows, model, loader),
                               (stats_j["AP50"], stats_j["AP"]), rtol=0, atol=AP_TOL)


def test_pred_rows_encode_like_jax(sets, tmp_path):
    paths = sorted(os.path.join(sets["native"]["val"], p) for p in os.listdir(sets["native"]["val"]))
    rng = np.random.default_rng(0)
    rows = [{"image_id": os.path.splitext(os.path.basename(paths[int(i)]))[0],
             "category_id": int(rng.integers(0, NC)),
             "bbox": [round(float(v), 3) for v in rng.uniform(0, 100, 4)],
             "score": round(float(rng.uniform()), 5)} for i in rng.integers(0, len(paths), 9)]
    enc = encode_pred_rows(rows, paths)
    np.testing.assert_array_equal(enc, jax_encode_pred_rows(rows, paths))
    assert decode_pred_rows(enc, paths) == jax_decode_pred_rows(enc, paths) == rows


def test_load_state_dict_file_folds_a_train_form_dict(tmp_path):
    torch.manual_seed(0)
    train = build_model(small_s_config(Config), num_classes=NC, deploy=False, device="cpu")
    with torch.no_grad():
        for name, buf in train.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    path = str(tmp_path / "train.pt")
    torch.save({"model": train.state_dict()}, path)
    model = load_state_dict_file(path, small_s_config(Config), device="cpu")
    want = fold_to_deploy(train.state_dict())
    assert model.num_classes == NC and set(model.state_dict()) == set(want)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        load_state_dict_file(str(tmp_path / "missing.pt"), small_s_config(Config), device="cpu")


def test_evaler_and_cli_refuse_cuda_without_a_card(sets, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaler(dict(sets["native"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_cli.run(dict(sets["native"]), weights="unused.pt", config=S_CONFIG,
                     save_dir=str(tmp_path))


def test_evaler_refuses_plots_before_it_predicts(sets, tmp_path):
    """Construction with the plots succeeds, and a PR-metric run writes the
    five PNGs into ``save_dir`` (none without one); its ``pr_results`` equal
    those of a run without plots."""
    from yolov6_tpu_torch.data.image_io import imread

    torch.manual_seed(0)
    model = build_model(small_s_config(Config), num_classes=NC, device="cpu")
    results = {}
    for plots in (False, True):
        out = tmp_path / str(plots)
        out.mkdir()
        ev = Evaler(dict(sets["native"]), batch_size=BATCH, img_size=EVAL_IMG_SIZE,
                    conf_thres=0.0, half=False, save_dir=str(out), do_pr_metric=True,
                    plot_curve=plots, plot_confusion_matrix=plots, device="cpu")
        ev.init_model(model)
        ev.predict_model(model, ev.init_data(None, "val"))
        results[plots] = ev.pr_results
        pngs = sorted(p.name for p in out.glob("*.png"))
        assert pngs == (sorted(["PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png",
                                "confusion_matrix.png"]) if plots else [])
        for name in pngs:
            assert imread(str(out / name)).shape == (1500, 2250, 3)
    assert results[True] is not None and results[True] == results[False]


def _small_s_files(tmp_path):
    """A config file of small S and a state dict of it, the head spread so
    that it detects."""
    torch.manual_seed(0)
    model = build_model(small_s_config(Config), num_classes=NC, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "_preds." in name:
                p.normal_(0.0, 0.05) if name.endswith(".weight") else p.uniform_(-3.0, 1.0)
    cfg_path = tmp_path / "small_s.py"
    with open(S_CONFIG) as f:
        cfg_path.write_text(f.read() + "\nmodel['depth_multiple'] = 0.1\n"
                            "model['width_multiple'] = 0.125\n")
    weights = tmp_path / "small_s.pt"
    torch.save({"ema": model.state_dict()}, weights)
    return cfg_path, weights


def test_cli_evaluates_a_saved_state_dict(sets, tmp_path):
    """``python -m yolov6_tpu_torch.tools.eval`` on small S (a config file and
    a state dict written here, the head spread so that it detects) exits 0
    with the mAP line."""
    cfg_path, weights = _small_s_files(tmp_path)
    cmd = [sys.executable, "-m", "yolov6_tpu_torch.tools.eval", "--data",
           os.path.join(os.path.dirname(os.path.dirname(sets["native"]["val"])), "data.json"),
           "--config", str(cfg_path), "--weights", str(weights), "--device", "cpu",
           "--batch-size", str(BATCH), "--img-size", str(EVAL_IMG_SIZE),
           "--save_dir", str(tmp_path / "runs"), "--infer_on_rect"]
    res = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO_ROOT})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mAP@0.5:" in res.stderr and "Average Precision" in res.stdout, res.stderr[-3000:]
    assert os.path.exists(tmp_path / "runs" / "exp" / "predictions.json")


def test_cli_plot_flags_parse_and_write_as_jaxs(sets, tmp_path):
    """``--plot_curve`` (default true; ``false``, ``0``, ``no`` in any case
    turn it off) and ``--plot_confusion_matrix`` parse as the JAX CLI's; with
    ``--do_pr_metric`` a run at the defaults writes the four curve PNGs and
    ``--plot_confusion_matrix`` adds the fifth."""
    import importlib.util

    from yolov6_tpu_torch.data.image_io import imread

    spec = importlib.util.spec_from_file_location("_jax_eval_cli",
                                                  os.path.join(REPO_ROOT, "tools", "eval.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    for argv in ([], ["--plot_curve", "false"], ["--plot_curve", "No"], ["--plot_curve", "0"],
                 ["--plot_curve", "True"], ["--plot_confusion_matrix"],
                 ["--do_pr_metric", "--plot_curve", "yes", "--plot_confusion_matrix"]):
        ours = eval_cli.get_args_parser().parse_args(argv)
        theirs = jax_cli.get_args_parser().parse_args(argv)
        for key in ("plot_curve", "plot_confusion_matrix", "do_pr_metric"):
            assert getattr(ours, key) == getattr(theirs, key), (argv, key)

    cfg_path, weights = _small_s_files(tmp_path)
    data = os.path.join(os.path.dirname(os.path.dirname(sets["native"]["val"])), "data.json")
    curves = ["F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png"]
    for name, extra, want in (("defaults", [], curves),
                              ("matrix", ["--plot_confusion_matrix"],
                               sorted(curves + ["confusion_matrix.png"]))):
        args = eval_cli.get_args_parser().parse_args([
            "--data", data, "--config", str(cfg_path), "--weights", str(weights),
            "--device", "cpu", "--batch-size", str(BATCH), "--img-size", str(EVAL_IMG_SIZE),
            "--save_dir", str(tmp_path / "runs"), "--name", name, "--do_pr_metric",
            "--conf-thres", "0.001", *extra])
        eval_cli.main(args)
        out = tmp_path / "runs" / name
        assert sorted(p.name for p in out.glob("*.png")) == want
        assert all(imread(str(out / p)).shape == (1500, 2250, 3) for p in want)
