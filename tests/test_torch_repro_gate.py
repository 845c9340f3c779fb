"""The port's COCO reproduction gate (yolov6_tpu_torch/tools/repro_gate.py)
against the JAX package's (tools/repro_gate.py) on a 4-image COCO-layout set
(``images/val2017``, ``annotations/instances_val2017.json``) with an
upstream-format N ``.pt`` written by ``write_upstream_checkpoint`` (full
width, 80 classes, seeded weights whose head scores spread). The ground
truth is the port's own top detections, so the mAP is far from 0 and from
the published 37.5: the gate FAILs with exit code 1.

Both gates run the published protocol (eval_640_repro.py's 640 and shrink
4, conf 0.03, IoU 0.65) and its exact-NMS second eval (K 30,000, per-anchor
top-k rows) on the CPU in fp32 (each side's eval ``run`` wrapped with
``half=False``: bf16 on the CPU rounds differently in the two frameworks).
Tolerance: the rows' mAP and nmsΔ within 0.01 mAP points; the target, the
PASS/FAIL word and the exit code equal. The JAX gate reads the same file
through its own import with the stub ``yolov6`` package on the path, and
its ``download_ckpt`` is replaced by a function that fails the test: it is
never reached. A missing ``.pt`` is ``SKIP (no weights)``, no model
evaluated is exit code 2, and a ``.msgpack`` raises ``ValueError``."""

import functools
import importlib.util
import json
import os
import os.path as osp

import cv2
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.tools import repro_gate
from yolov6_tpu_torch.tools.eval import run as eval_run
from yolov6_tpu_torch.utils.coco_eval import coco80_to_coco91_class
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.upstream_ckpt import write_upstream_checkpoint

from test_torch_upstream_ckpt import StubOnPath
from torch_image_fixtures import smooth_image
from torch_port_utils import N_CONFIG, REPO_ROOT

MAP_TOL = 0.01  # mAP points
SIZES = [(96, 72), (80, 100), (120, 90), (64, 64)]


def _n_model():
    torch.manual_seed(0)
    model = build_model(Config.fromfile(N_CONFIG), num_classes=80, deploy=False, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "_preds" in name and p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3 / p[0].numel() ** 0.5)
            elif "_preds" in name:
                low, high = (-4.0, 1.0) if "cls_preds" in name else (1.0, 3.0)
                p.uniform_(low, high, generator=gen)
    return model.eval()


def _write_gt(root, rows):
    coco91 = coco80_to_coco91_class()
    images, anns = [], []
    for i, (w, h) in enumerate(SIZES):
        images.append(dict(id=i + 1, file_name=f"{i + 1:012d}.jpg", width=w, height=h))
    for k, r in enumerate(rows):
        x, y, bw, bh = r["bbox"]
        anns.append(dict(id=k + 1, image_id=r["image_id"], category_id=r["category_id"],
                         bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0, segmentation=[]))
    with open(osp.join(root, "annotations", "instances_val2017.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=c, name=str(c)) for c in coco91]), f)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    for sub in ("images/val2017", "annotations", "weights", "stub"):
        os.makedirs(osp.join(root, sub))
    for i, (w, h) in enumerate(SIZES):
        assert cv2.imwrite(osp.join(root, "images", "val2017", f"{i + 1:012d}.jpg"),
                           smooth_image(h, w, i))
    weights = write_upstream_checkpoint(osp.join(root, "weights", "yolov6n.pt"), _n_model(),
                                        osp.join(root, "stub"))
    # a first eval against a placeholder truth gives the detections that
    # become the truth: each image's five best
    _write_gt(root, [dict(image_id=i + 1, category_id=1, bbox=[1, 1, 20, 20])
                     for i in range(len(SIZES))])
    data = repro_gate.build_coco_data_dict(root)
    _, rows = eval_run(data, weights=weights, config=N_CONFIG, batch_size=4, img_size=640,
                       shrink_size=4, half=False, save_dir=osp.join(root, "probe"), device="cpu")
    best = []
    for i in range(len(SIZES)):
        mine = sorted((r for r in rows if r["image_id"] == i + 1), key=lambda r: -r["score"])
        assert len(mine) >= 5
        best += mine[:5]
    _write_gt(root, best)
    return root


def _fp32(run):
    return functools.partial(run, half=False)


def _port_gate(monkeypatch, coco, tmp_path, *extra):
    monkeypatch.setattr(repro_gate, "eval_run", _fp32(eval_run))
    out = str(tmp_path / "port.json")
    args = repro_gate.get_args_parser().parse_args([
        "--coco-root", coco, "--weights-dir", osp.join(coco, "weights"), "--batch-size", "4",
        "--save-dir", str(tmp_path / "port"), "--out-json", out, "--device", "cpu", *extra])
    code = repro_gate.main(args)
    with open(out) as f:
        return code, json.load(f)


def _jax_gate(monkeypatch, coco, tmp_path, *extra):
    import yolov6_tpu.utils.general as jax_general

    def no_download(*a, **kw):
        raise AssertionError("the JAX gate reached download_ckpt")

    monkeypatch.setattr(jax_general, "download_ckpt", no_download)
    spec = importlib.util.spec_from_file_location(
        "jax_repro_gate", osp.join(REPO_ROOT, "tools", "repro_gate.py"))
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    run = gate._load_eval_run()
    monkeypatch.setattr(gate, "_load_eval_run", lambda: _fp32(run))
    out = str(tmp_path / "jax.json")
    args = gate.get_args_parser().parse_args([
        "--coco-root", coco, "--weights-dir", osp.join(coco, "weights"), "--batch-size", "4",
        "--save-dir", str(tmp_path / "jax"), "--out-json", out, *extra])
    with StubOnPath(osp.join(coco, "stub")):
        code = gate.main(args)
    with open(out) as f:
        return code, json.load(f), gate


def test_gate_rows_and_exit_code_equal_jax(monkeypatch, coco, tmp_path, capsys):
    code, rows = _port_gate(monkeypatch, coco, tmp_path, "--models", "yolov6n", "yolov6s")
    table = capsys.readouterr().out
    code_j, rows_j, jax_gate = _jax_gate(monkeypatch, coco, tmp_path, "--models", "yolov6n")
    assert repro_gate.TARGETS == jax_gate.TARGETS
    assert code == code_j == 1
    n, s = rows
    (n_j,) = rows_j
    assert n["model"] == n_j["model"] == "yolov6n" and n["target"] == n_j["target"] == 37.5
    assert 10.0 < n["map"] < 100.0  # the truth is the model's own detections
    assert abs(n["map"] - n_j["map"]) <= MAP_TOL, (n, n_j)
    assert abs(n["nms_delta"] - n_j["nms_delta"]) <= MAP_TOL, (n, n_j)
    assert n["status"].split()[0] == n_j["status"].split()[0] == "FAIL"
    assert "nmsΔ=" in n["status"] and "nmsΔ=" in n_j["status"]
    assert s == dict(model="yolov6s", map=None, target=45.0, status="SKIP (no weights)",
                     nms_delta=None)
    lines = table.strip().splitlines()[-3:]
    assert lines[0].split() == ["model", "mAP50:95", "target", "nmsΔ", "status"]
    assert lines[1].startswith("yolov6n") and "FAIL" in lines[1]
    assert lines[2].split()[:4] == ["yolov6s", "—", "45.0", "—"] and "SKIP (no weights)" in lines[2]


def test_gate_without_weights_exits_2_and_downloads_nothing(monkeypatch, coco, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()

    def no_eval(*a, **kw):
        raise AssertionError("nothing to evaluate")

    monkeypatch.setattr(repro_gate, "eval_run", no_eval)
    args = repro_gate.get_args_parser().parse_args([
        "--coco-root", coco, "--weights-dir", str(empty), "--save-dir", str(tmp_path / "p"),
        "--out-json", str(tmp_path / "o.json"), "--device", "cpu"])
    assert repro_gate.main(args) == 2
    with open(tmp_path / "o.json") as f:
        rows = json.load(f)
    assert [r["model"] for r in rows] == list(repro_gate.TARGETS)
    assert all(r["status"] == "SKIP (no weights)" and r["map"] is None for r in rows)
    (empty / "yolov6s.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="msgpack"):
        repro_gate.main(args)
    with pytest.raises(FileNotFoundError, match="val2017"):
        repro_gate.build_coco_data_dict(str(empty))
    with open(repro_gate.__file__) as f:
        src = f.read()
    for fetch in ("download_ckpt", "urllib", "requests", "http", "socket"):
        assert fetch not in src, fetch


def test_gate_reads_coco_yaml_without_yaml(coco):
    """``data/coco.yaml`` (a multi-line names list) through the port's
    ``load_yaml``, with the val split and annotations pointed at the root."""
    data = repro_gate.build_coco_data_dict(coco)
    assert data["nc"] == 80 and len(data["names"]) == 80 and data["is_coco"] is True
    assert data["val"] == osp.join(coco, "images", "val2017")
    assert data["anno_path"] == osp.join(coco, "annotations", "instances_val2017.json")
