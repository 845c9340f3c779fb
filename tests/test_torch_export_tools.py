"""The port's export-side runners and ONNX PTQ against the JAX package's
tools, on the CPU, on the same files:

- ``tools/infer_torchscript.py``: the port's traced small S (its TorchScript
  artifact) on a demo JPEG through the port's runner and the JAX runner
  (cv2 resize and ``NMSBoxesBatched``): the same detections, boxes within
  1 px (the floor/ceil rounding), scores within 1e-5; the drawn PNG written;
- ``tools/onnx_demo.py``: the port's ONNX file of small S on generated PNGs
  through both demos' ``infer_frame`` (the port's runs it as torch ops with
  ``OnnxTorchModule`` and keeps through ``non_max_suppression``, the JAX one
  through the numpy runner and its numpy NMS): detections within 1e-3 px and
  1e-5; and the port's ORT-tail end2end file through its ``infer_frame``
  equal to the same file through the JAX demo;
- ``quant/onnx_ptq.py`` and ``tools/quantization_ppq.py``: ``calibrate_onnx``
  ranges on the same file and batches equal the JAX ones (relative 1e-6),
  the qparams JSON and the QDQ file's ops too;
- ``quant/trt_calibrator.py``: the batches equal the JAX stream's on the same
  PNG files (the port's letterbox resizes as cv2 does, bit for bit), the
  cache reader equals JAX's; without ``tensorrt`` the TensorRT paths raise.
A video file raises ``FileNotFoundError`` in both TorchScript runners (the
JAX tool's ``cv2.imread`` finds no image in it); the ONNX demo's video loop
is held against the JAX demo's in ``tests/test_torch_video_infer.py``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.export.onnx_numpy import OnnxRunner as JaxOnnxRunner
from yolov6_tpu.quant import onnx_ptq as jax_onnx_ptq
from yolov6_tpu.quant import trt_calibrator as jax_trt_calibrator

from yolov6_tpu_torch.data.image_io import imread
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.export.onnx_export import export_onnx
from yolov6_tpu_torch.export.onnx_quant import save_calib_cache_file
from yolov6_tpu_torch.export.torch_export import (
    DeployForward, OnnxTorchModule, export_torchscript,
)
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.quant import onnx_ptq, trt_calibrator
from yolov6_tpu_torch.tools import infer_torchscript, onnx_demo, quantization_ppq
from yolov6_tpu_torch.utils.config import Config

from torch_port_utils import REPO_ROOT, small_s_config

IMG = 64
sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))


def _jax_tool(name):
    import importlib

    return importlib.import_module(name)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_tools")
    torch.manual_seed(0)
    model = build_model(small_s_config(Config), num_classes=4, device="cpu")
    with torch.no_grad():  # spread class scores; boxes of 2-4 strides a side
        for conv in list(model.detect.cls_preds) + list(model.detect.reg_preds):
            conv.weight.normal_(0, 0.05)
            conv.bias.fill_(1.5 if conv in model.detect.reg_preds else 0.0)
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    onnx_path = str(root / "s.onnx")
    export_onnx(DeployForward(model), (x,), onnx_path, input_names=["images"],
                output_names=["outputs"])
    onnx_e2e = export_onnx(DeployForward(model), (x,), input_names=["images"],
                           nms=dict(max_obj=30, iou_thres=0.45, score_thres=0.3))
    ts_path = str(root / "s.torchscript.pt")
    export_torchscript(model, (x,), ts_path)
    data = generate_synth_dataset(str(root / "set"), n_train=0, n_val=4, img_size=96, seed=3,
                                  sizes=[(96, 72), (72, 96), (80, 80), (96, 96)])
    val = os.path.join(os.path.dirname(data), "images", "val")
    return dict(root=root, onnx=onnx_path, onnx_e2e=onnx_e2e, ts=ts_path, val=val,
                pngs=sorted(os.path.join(val, p) for p in os.listdir(val)))


def test_infer_torchscript_matches_jax_runner(setup, tmp_path):
    jpeg = os.path.join(REPO_ROOT, "data", "images", "image1.jpg")
    kw = dict(img_size=(IMG, IMG), conf_thres=0.3, iou_thres=0.45)
    got = infer_torchscript.run(jpeg, setup["ts"], out_dir=str(tmp_path), device="cpu", **kw)
    want = _jax_tool("infer_torchscript").run(jpeg, setup["ts"], **kw)
    assert len(want) > 3 and got.shape == want.shape
    order_g, order_w = np.lexsort(got.T[::-1]), np.lexsort(want.T[::-1])
    np.testing.assert_allclose(got[order_g, :4], want[order_w, :4], atol=1)
    np.testing.assert_allclose(got[order_g, 4:], want[order_w, 4:], atol=1e-5)
    drawn = imread(str(tmp_path / "image1.jpg"))
    assert drawn.shape == imread(jpeg).shape
    # the JAX tool's cv2.imread finds no image in a video: FileNotFoundError
    import cv2

    writer = cv2.VideoWriter(str(tmp_path / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (64, 48))
    writer.write(np.zeros((48, 64, 3), np.uint8))
    writer.release()
    with pytest.raises(FileNotFoundError, match="clip.mp4"):
        _jax_tool("infer_torchscript").run(str(tmp_path / "clip.mp4"), setup["ts"], **kw)
    with pytest.raises(FileNotFoundError, match="clip.mp4"):
        infer_torchscript.run(str(tmp_path / "clip.mp4"), setup["ts"], device="cpu", **kw)


def _by_class_then_box(dets):
    """Detections in (class, x0, y0, x1, y1, score) order: near-equal scores
    may order differently between torch's and numpy's convolutions."""
    return dets[np.lexsort((dets[:, 4], dets[:, 3], dets[:, 2], dets[:, 1], dets[:, 0],
                            dets[:, 5]))]


def test_onnx_demo_matches_jax_demo(setup):
    runner = OnnxTorchModule(open(setup["onnx"], "rb").read())
    jdemo = _jax_tool("onnx_demo")
    jrunner = JaxOnnxRunner(open(setup["onnx"], "rb").read())
    import cv2

    n = 0
    for path in setup["pngs"]:
        got = onnx_demo.infer_frame(runner, imread(path), IMG, IMG, 0.3, 0.45, "cpu")
        want = jdemo.infer_frame(jrunner, cv2.imread(path), IMG, IMG, 0.3, 0.45)
        assert got.shape == want.shape
        got, want = _by_class_then_box(got), _by_class_then_box(want)
        np.testing.assert_array_equal(got[:, 5], want[:, 5])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
        np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=1e-5)
        n += len(got)
    assert n > 3
    args = onnx_demo.get_args_parser().parse_args(
        ["--model", setup["onnx"], "--source", setup["pngs"][0], "--save",
         str(setup["root"] / "demo.png"), "--device", "cpu"])
    assert len(onnx_demo.main(args)) == len(
        onnx_demo.infer_frame(runner, imread(setup["pngs"][0]), IMG, IMG, 0.4, 0.45, "cpu"))
    with pytest.raises(FileNotFoundError, match="clip.mp4"):  # a video path: run_video
        onnx_demo.main(onnx_demo.get_args_parser().parse_args(
            ["--model", setup["onnx"], "--source", "clip.mp4", "--device", "cpu"]))
    # an end2end file (the ORT NonMaxSuppression tail) through both demos
    e2e = OnnxTorchModule(setup["onnx_e2e"])
    je2e = JaxOnnxRunner(setup["onnx_e2e"])
    n = 0
    for path in setup["pngs"]:
        got = onnx_demo.infer_frame(e2e, imread(path), IMG, IMG, 0.3, 0.45, "cpu")
        want = jdemo.infer_frame(je2e, cv2.imread(path), IMG, IMG, 0.3, 0.45)
        assert got.shape == want.shape
        got, want = _by_class_then_box(got), _by_class_then_box(want)
        np.testing.assert_array_equal(got[:, 5], want[:, 5])
        np.testing.assert_allclose(got[:, :5], want[:, :5], atol=1e-3)
        n += len(got)
    assert n > 3


def test_calibrate_onnx_and_ppq_entry_match_jax(setup, tmp_path):
    data = open(setup["onnx"], "rb").read()
    batches = [np.random.default_rng(i).uniform(0, 1, (1, IMG, IMG, 3)).astype(np.float32)
               for i in range(2)]
    got, want = onnx_ptq.calibrate_onnx(data, batches), jax_onnx_ptq.calibrate_onnx(data, batches)
    assert set(got) == set(want) and len(got) > 20
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    argv = ["--onnx", setup["onnx"], "--calib-dir", setup["val"], "--img-size", str(IMG),
            "--calib-steps", "2"]
    jppq = _jax_tool("quantization_ppq")
    for mod, tag in ((quantization_ppq, "port"), (jppq, "jax")):
        out = ["--output", str(tmp_path / f"{tag}.onnx"),
               "--qparams", str(tmp_path / f"{tag}.json")]
        assert mod.main(mod.get_args_parser().parse_args(argv + out)) == 0
    got = json.load(open(tmp_path / "port.json"))["act_quant_info"]
    want = json.load(open(tmp_path / "jax.json"))["act_quant_info"]
    assert set(got) == set(want)
    assert all(got[k] == pytest.approx(want[k], rel=1e-6) for k in got)
    from yolov6_tpu_torch.export.onnx_proto import parse_model

    ops = [n.op_type for n in parse_model(open(tmp_path / "port.onnx", "rb").read()).nodes]
    jops = [n.op_type for n in parse_model(open(tmp_path / "jax.onnx", "rb").read()).nodes]
    assert ops == jops and ops.count("QuantizeLinear") > 10


def test_trt_calibrator_stream_and_cache_match_jax(setup, tmp_path):
    mine = trt_calibrator.CalibrationDataLoader(2, 2, setup["val"], IMG, IMG)
    theirs = jax_trt_calibrator.CalibrationDataLoader(2, 2, setup["val"], IMG, IMG)
    for _ in range(3):  # two batches, then the exhausted stream's empty array
        got, want = mine.next_batch(), theirs.next_batch()
        np.testing.assert_array_equal(got, want)
    assert got.size == 0 and len(mine) == 2
    with pytest.raises(ValueError):
        trt_calibrator.CalibrationDataLoader(4, 2, setup["val"], IMG, IMG)
    cache = str(tmp_path / "calib.cache")
    save_calib_cache_file(cache, {"a": "3c23d70a", "b/c": "3f800000"})
    assert trt_calibrator.read_calib_cache_file(cache) == \
        jax_trt_calibrator.read_calib_cache_file(cache)


def test_tensorrt_paths_raise_without_tensorrt(setup, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorrt", None)
    stream = trt_calibrator.CalibrationDataLoader(1, 1, setup["val"], IMG, IMG)
    with pytest.raises(RuntimeError, match="tensorrt"):
        trt_calibrator.make_calibrator(stream, str(tmp_path / "c.cache"))
    with pytest.raises(RuntimeError, match="tensorrt"):
        onnx_ptq.build_trt_engine_with_qparams(setup["onnx"], str(tmp_path / "q.json"),
                                               str(tmp_path / "e.engine"))
