"""The port's video entry points against the JAX package's on the CPU:
``LoadData`` over a directory of two images and two clips, ``Inferer.infer``
over a clip, and ``tools/onnx_demo.py::run_video`` over the same clip.

The clips are written by ``cv2.VideoWriter`` (mp4v in MP4 and Motion JPEG in
AVI). ``Inferer.infer`` runs one small N (random weights, one JAX trace for
the module) on both sides, fed the same frames: the port's ``LoadData``
reads the clip through ``cv2.VideoCapture`` for this test (patched in), and
``CalcFPS`` is pinned, so that the FPS overlays carry the same text. The
label rows are equal as in ``tests/test_torch_inferer.py``, and so are the
rows each frame adds; the drawn frames (caught on their way to each side's
writer, labels hidden) are equal outside the overlay's box and the
anti-aliased edges of that frame's own outlines, as in that file's drawing
test; the written files have the same frame count, fps and size under
``cv2.VideoCapture``.
"""

import gc
import os
import re
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

import yolov6_tpu.core.inferer as jax_inferer_module
from yolov6_tpu.core.inferer import Inferer as JaxInferer
from yolov6_tpu.data.datasets import LoadData as JaxLoadData
from yolov6_tpu.export.onnx_numpy import OnnxRunner as JaxOnnxRunner
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from yolov6_tpu.utils.config import Config as JaxConfig

import yolov6_tpu_torch.core.inferer as inferer_module
import yolov6_tpu_torch.data.datasets as datasets_module
from yolov6_tpu_torch.core.inferer import Inferer
from yolov6_tpu_torch.data import video
from yolov6_tpu_torch.data.datasets import LoadData
from yolov6_tpu_torch.export.onnx_export import export_onnx
from yolov6_tpu_torch.export.torch_export import DeployForward
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.tools import onnx_demo
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_inferer import NAMES, NC, _assert_rows_equal, _band_edge_distance, _rows, \
    _small_n_config_file
from torch_port_utils import REPO_ROOT, random_jax_variables, small_s_config
from torch_video_fixtures import moving_frames

IMG = 160
INFER = dict(conf_thres=0.3, iou_thres=0.45, max_det=1000)
PINNED_FPS = 12.5
CLIP = (128, 96, 12)  # w, h, frames


def _write_clip(path, fourcc, seed):
    w, h, n = CLIP
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
    for f in moving_frames(w, h, n, seed):
        writer.write(f)
    writer.release()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("video_infer")
    src = root / "src"
    src.mkdir()
    for i in (1, 2):
        shutil.copy(os.path.join(REPO_ROOT, "data", "images", f"image{i}.jpg"), src)
    _write_clip(str(src / "clip_a.mp4"), "mp4v", 0)
    _write_clip(str(src / "clip_b.avi"), "MJPG", 1)
    one = root / "one"
    one.mkdir()
    shutil.copy(src / "clip_a.mp4", one)
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
    return dict(root=root, src=str(src), one=str(one), yaml=str(yaml_path), cfg=cfg_path,
                ckpt=ckpt, weights=weights)


def test_load_data_matches_jax(setup):
    ours, theirs = LoadData(setup["src"]), JaxLoadData(setup["src"])
    assert ours.files == theirs.files and len(ours) == len(theirs) == 4
    n_video = 0
    for (img, path, cap), (img_j, path_j, cap_j) in zip(ours, theirs, strict=True):
        assert path == path_j and ours.type == theirs.type
        assert (cap is None) == (cap_j is None) and img.shape == img_j.shape
        assert np.array_equal(img, img_j), path
        n_video += ours.type == "video"
    assert n_video == 2 * CLIP[2]


def _count_lines(path):
    """The rows a label file holds so far (none before its first row)."""
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return len(f.read().splitlines())


class _JaxWriterSpy:
    """cv2 for the JAX inferer's module, whose VideoWriter records each frame
    on its way to a real cv2 writer, and the rows the label file ``labels``
    holds then (each frame's rows are appended before its frame is written)."""

    def __init__(self, frames, labels):
        spy = self

        class VideoWriter:
            def __init__(self, path, fourcc, fps, size):
                spy.opened.append((path, fps, size))
                self._w = cv2.VideoWriter(path, fourcc, fps, size)

            def write(self, frame):
                frames.append(frame.copy())
                spy.rows_at_write.append(_count_lines(labels))
                self._w.write(frame)

            def release(self):
                self._w.release()

        self.opened = []
        self.rows_at_write = []
        self.VideoWriter = VideoWriter

    def __getattr__(self, name):
        return getattr(cv2, name)


def _meta(path):
    cap = cv2.VideoCapture(path)
    out = (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS),
           cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    return out


def test_inferer_video_matches_jax(setup, tmp_path, monkeypatch):
    ours_frames, theirs_frames, ours_rows_at_write = [], [], []
    out, out_j = str(tmp_path / "ours"), str(tmp_path / "theirs")
    labels, labels_j = (os.path.join(d, "one", "labels", "clip_a.txt") for d in (out, out_j))
    monkeypatch.setattr(jax_inferer_module.CalcFPS, "accumulate", lambda self: PINNED_FPS)
    monkeypatch.setattr(inferer_module.CalcFPS, "accumulate", lambda self: PINNED_FPS)
    monkeypatch.setattr(datasets_module, "VideoCapture", cv2.VideoCapture)  # cv2's frames
    spy = _JaxWriterSpy(theirs_frames, labels_j)
    monkeypatch.setattr(jax_inferer_module, "cv2", spy)

    class RecordingWriter(video.VideoWriter):
        def write(self, frame):
            ours_frames.append(frame.copy())
            ours_rows_at_write.append(_count_lines(labels))
            super().write(frame)

    monkeypatch.setattr(inferer_module, "VideoWriter", RecordingWriter)
    args = dict(INFER, classes=None, agnostic_nms=False, save_txt=True, save_img=True,
                hide_labels=True, hide_conf=False)
    ours = Inferer(setup["one"], False, "0", setup["weights"], setup["cfg"], setup["yaml"], IMG,
                   False, device="cpu")
    ours.infer(save_dir=out, **args)
    theirs = JaxInferer(setup["one"], False, "0", setup["ckpt"], setup["cfg"], setup["yaml"],
                        IMG, False)
    theirs.infer(save_dir=out_j, **args)
    del theirs
    gc.collect()  # the JAX inferer leaves its last writer to the collector

    rows, rows_j = _rows(labels), _rows(labels_j)
    _assert_rows_equal(rows, rows_j)
    assert len(rows) >= CLIP[2]
    # each frame's rows: those appended before its frame went to the writer
    assert ours_rows_at_write == spy.rows_at_write and ours_rows_at_write[-1] == len(rows)
    ends = ours_rows_at_write
    per_frame = [rows[a:b] for a, b in zip([0] + ends[:-1], ends)]
    for k, (a, b) in enumerate(zip([0] + ends[:-1], ends)):
        _assert_rows_equal(per_frame[k], rows_j[a:b])
    assert len({tuple(r) for r in per_frame}) > 1  # the boxes move from frame to frame

    path, path_j = (os.path.join(d, "one", "clip_a.mp4") for d in (out, out_j))
    assert _meta(path) == _meta(path_j) == (CLIP[2], 25.0, CLIP[0], CLIP[1])
    assert spy.opened == [(path_j, 25.0, (CLIP[0], CLIP[1]))]

    # the drawn frames: equal outside the overlay's box (its text is the
    # port's font) and within 2 px of none of that frame's own outlines' band
    # edges (1 px, as in test_torch_inferer.py, and 1 for the corners read
    # back from the rows)
    assert len(ours_frames) == len(theirs_frames) == CLIP[2]
    text_w, text_h = cv2.getTextSize(f"FPS: {PINNED_FPS:0.1f}", cv2.FONT_HERSHEY_SIMPLEX, 1.0,
                                     2)[0]
    yy, xx = np.mgrid[0:CLIP[1], 0:CLIP[0]]
    in_overlay = (xx >= 15) & (xx <= 25 + text_w) & (yy >= 15) & (yy <= 25 + text_h)
    lw = max(round(sum((CLIP[1], CLIP[0], 3)) / 2 * 0.003), 2)
    for k, (got, want) in enumerate(zip(ours_frames, theirs_frames)):
        near = np.zeros_like(in_overlay)
        for box in _corners(per_frame[k]):
            near |= _band_edge_distance(got.shape, box[:2], box[2:], lw) <= 2
        differs = (got != want).any(2) & ~in_overlay & ~near
        assert not differs.any(), (k, np.argwhere(differs)[:5])
        assert (got[in_overlay] == 255).mean() > 0.5  # the overlay's white box is drawn


def _corners(rows):
    """The integer corners of the boxes that the label rows of one frame
    describe (class, normalised centre and size, confidence)."""
    boxes = []
    for r in rows:
        xc, yc, w, h = r[1] * CLIP[0], r[2] * CLIP[1], r[3] * CLIP[0], r[4] * CLIP[1]
        boxes.append((int(xc - w / 2), int(yc - h / 2), int(xc + w / 2), int(yc + h / 2)))
    return boxes


def test_onnx_demo_video_matches_jax(setup, tmp_path, capsys):
    sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
    import importlib

    jdemo = importlib.import_module("onnx_demo")
    size = 64
    torch.manual_seed(0)
    model = build_model(small_s_config(Config), num_classes=NC, device="cpu")
    with torch.no_grad():  # spread class scores; boxes of 2-4 strides a side
        for conv in list(model.detect.cls_preds) + list(model.detect.reg_preds):
            conv.weight.normal_(0, 0.05)
            conv.bias.fill_(1.5 if conv in model.detect.reg_preds else 0.0)
    onnx_path = str(tmp_path / "s.onnx")
    export_onnx(DeployForward(model), (np.zeros((1, size, size, 3), np.float32),), onnx_path,
                input_names=["images"], output_names=["outputs"])
    clip = os.path.join(setup["one"], "clip_a.mp4")
    argv = ["--model", onnx_path, "--source", clip, "--conf-thres", "0.3", "--max-frames", "10"]
    args = onnx_demo.get_args_parser().parse_args(
        argv + ["--save", str(tmp_path / "ours.mp4"), "--device", "cpu"])
    frames, dets = onnx_demo.main(args)
    ours_out = capsys.readouterr().out.splitlines()
    jargs = onnx_demo.get_args_parser().parse_args(argv + ["--save", str(tmp_path / "jax.mp4")])
    jdemo.run_video(JaxOnnxRunner(open(onnx_path, "rb").read()), size, size, jargs)
    jax_out = capsys.readouterr().out.splitlines()
    assert frames == 10 and dets > 10
    assert ours_out[-1] == jax_out[-1] == f"{frames} frames, {dets} detections"
    assert _meta(str(tmp_path / "ours.mp4")) == _meta(str(tmp_path / "jax.mp4")) == (
        10, 25.0, CLIP[0], CLIP[1])
    assert not re.search(r"\d+ frames", "".join(ours_out[:-1]))
