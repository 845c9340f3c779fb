"""The port's export CLI (``python -m yolov6_tpu_torch.tools.export``; JAX:
tools/export.py) on the CPU: each format's ``--check`` passes on small S at
64 px (Lite-S for ``ncnn``): ``pt2`` end2end with the preprocessing folded
in and plain, ``onnx`` plain, end2end (ORT tail), dynamic-batch, fp16 and
INT8 QDQ from a PTQ checkpoint's ranges, ``torchscript`` and ``ncnn``;
``openvino`` and ``tensorrt`` write the ONNX file and exit with the JAX
CLI's message when their tools are absent; the flags that are not ported
exit with their reason.
"""

import os

import numpy as np
import pytest
import torch

from yolov6_tpu_torch.export.onnx_proto import parse_model
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.quant.ptq import calibrate, quantize_variables
from yolov6_tpu_torch.tools import export as cli
from yolov6_tpu_torch.utils.config import Config

from torch_port_utils import REPO_ROOT, S_CONFIG

IMG = 64
LITE_S = os.path.join(REPO_ROOT, "configs", "yolov6_lite", "yolov6_lite_s.py")


def _seeded(model):
    torch.manual_seed(0)
    with torch.no_grad():
        for conv in list(model.detect.cls_preds) + list(model.detect.reg_preds):
            conv.weight.normal_(0, 0.05)
            conv.bias.zero_()
    return model


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_cli")
    torch.manual_seed(0)  # build_model's default init: not whatever ran before in the process
    conf = str(root / "yolov6s_small.py")
    with open(S_CONFIG) as f, open(conf, "w") as g:
        g.write(f.read() + "\nmodel['depth_multiple'] = 0.1\nmodel['width_multiple'] = 0.125\n")
    model = _seeded(build_model(Config.fromfile(conf), num_classes=4, device="cpu"))
    weights = str(root / "s.pt")
    torch.save(model.state_dict(), weights)
    x = np.random.default_rng(0).uniform(0, 255, (2, IMG, IMG, 3))
    amax = calibrate(model, [x])
    ptq = str(root / "s_ptq.pt")
    torch.save({"model": dict(quantize_variables(model.state_dict(), model), quant=amax)}, ptq)
    lite = _seeded(build_model(Config.fromfile(LITE_S), num_classes=4, device="cpu"))
    lite_weights = str(root / "lite_s.pt")
    torch.save(lite.state_dict(), lite_weights)
    return dict(root=root, conf=conf, weights=weights, ptq=ptq, lite=lite_weights)


def _run(files, *extra, weights=None, conf=None, name="out"):
    argv = ["--weights", weights or files["weights"], "--config", conf or files["conf"],
            "--img-size", str(IMG), "--batch-size", "2", "--device", "cpu", "--check", *extra]
    if not any(a == "--output" for a in extra):
        argv += ["--output", str(files["root"] / name)]
    return cli.main(cli.get_args_parser().parse_args(argv))


@pytest.mark.parametrize("extra", [
    ("--end2end", "--with-preprocess"), ("--end2end", "--half"), ()],
    ids=["end2end_preprocess", "end2end_bf16", "plain"])
def test_pt2(files, extra):
    path = _run(files, "--format", "pt2", *extra, name=f"s_{len(extra)}{extra[-1:] }.pt2")
    assert os.path.getsize(path) > 0


@pytest.mark.parametrize("extra", [(), ("--end2end",), ("--dynamic-batch",), ("--half",)],
                         ids=["plain", "end2end", "dynamic_batch", "fp16"])
def test_onnx(files, extra):
    path = _run(files, "--format", "onnx", *extra, name=f"s{'_'.join(extra)}.onnx")
    m = parse_model(open(path, "rb").read())
    names = [n for n, _, _ in m.outputs]
    assert names == (["num_dets", "det_boxes", "det_scores", "det_classes"]
                     if "--end2end" in extra else ["outputs"])
    if "--dynamic-batch" in extra:
        assert m.inputs[0][2][0] == "batch"


def test_onnx_quant_writes_qdq_and_companions(files):
    path = _run(files, "--format", "onnx", "--quant", weights=files["ptq"], name="s_q.onnx")
    ops = [n.op_type for n in parse_model(open(path, "rb").read()).nodes]
    assert ops.count("QuantizeLinear") == ops.count("Conv") > 10
    base = path.rsplit(".", 1)[0]
    assert os.path.exists(base + "_remove_qdq.onnx")
    assert os.path.exists(base + "_remove_qdq_calibration.cache")
    with pytest.raises(SystemExit, match="ranges"):
        _run(files, "--format", "onnx", "--quant", name="s_noq.onnx")


def test_torchscript(files):
    path = _run(files, "--format", "torchscript", name="s.torchscript.pt")
    assert torch.jit.load(path) is not None


@pytest.mark.parametrize("half", [False, True], ids=["fp32", "fp16"])
def test_ncnn(files, half):
    param = _run(files, "--format", "ncnn", *(["--half"] if half else []),
                 weights=files["lite"], conf=LITE_S, name=f"lite{int(half)}")
    assert param.endswith(".param") and os.path.exists(param[:-6] + ".bin")


@pytest.mark.parametrize("fmt,tool", [("openvino", "mo"), ("tensorrt", "trtexec")])
def test_vendor_formats_need_their_tools(files, fmt, tool, monkeypatch):
    monkeypatch.setattr(cli.shutil, "which", lambda name: None)
    with pytest.raises(SystemExit, match=tool):
        _run(files, "--format", fmt, name=f"{fmt}_out")
    assert os.path.exists(files["weights"].rsplit(".", 1)[0] + ".onnx")


@pytest.mark.parametrize("flags,reason", [
    (("--platforms", "cuda", "cpu"), "do-not-port"),
    (("--weights-as-args",), "do-not-port"),
    (("--shard-devices", "2"), "multi-card"),
    (("--runner-dir", "runner"), "do-not-port"),
    (("--format", "torchscript", "--end2end"), "incompatible"),
    (("--format", "ncnn", "--quant"), "incompatible"),
    (("--format", "onnx", "--dynamic-batch", "--end2end"), "per-batch"),
], ids=["platforms", "weights_as_args", "shard_devices", "runner_dir", "torchscript_end2end",
        "ncnn_quant", "dynamic_end2end"])
def test_refused_flags(files, flags, reason):
    with pytest.raises(SystemExit, match=reason):
        _run(files, *flags)
