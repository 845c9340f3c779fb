"""The port's INT8 QDQ ONNX (export/onnx_quant.py over the port's ONNX of a
``quant_mode`` graph) against the port's fake-quantised forward and the
JAX package's QDQ file, on the CPU.

Small S-opt-qat (RepOpt's RealVGG blocks, configs/repopt/yolov6s_opt_qat.py)
at 64 px, 16 classes, from seeded JAX variables carried across by
``state_dict_from_jax``; the port calibrates it on two images with
``detect/stems`` skipped, fake-quantises its conv weights (PTQ), and the
JAX package gets the same ranges (its ``quant`` collection) and its own
weight step, which tests/test_torch_ptq.py holds bit-equal to the port's. Then:

- ``rewrite_qdq`` rewrites every quantised conv input: one QuantizeLinear a
  conv of ``quant_paths(model)`` less the skipped ones, no Round or Where
  left; each conv's weight goes int8 through a per-channel DequantizeLinear;
- run through the numpy runner, the QDQ file equals the port's fake-quant
  forward plus decode within atol 5e-4 / rtol 1e-4 (the JAX
  ``test_onnx_qdq`` tolerance);
- ``remove_qdq`` gives a plain graph whose outputs equal those of the JAX
  file's plain graph (same tolerance), and the calibration cache holds the
  same scales, in the same TRT layout, as the JAX one's.
"""

import functools
import os
import struct

import numpy as np
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.export.onnx_export import export_onnx as jax_export_onnx
from yolov6_tpu.export.onnx_quant import remove_qdq as jax_remove_qdq
from yolov6_tpu.export.onnx_quant import to_qdq as jax_to_qdq
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.quant import set_quant_mode
from yolov6_tpu.quant.ptq import quantize_variables as jax_quantize_variables
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.export.onnx_export import export_onnx
from yolov6_tpu_torch.export.onnx_numpy import OnnxRunner
from yolov6_tpu_torch.export.onnx_proto import parse_model
from yolov6_tpu_torch.export.onnx_quant import remove_qdq, save_calib_cache_file, to_qdq
from yolov6_tpu_torch.export.torch_export import DeployForward
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.quant.ptq import calibrate, quantize_variables
from yolov6_tpu_torch.quant.state import quant_mode, quant_paths
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import REPO_ROOT, random_jax_variables, small_config

S_OPT_QAT = os.path.join(REPO_ROOT, "configs", "repopt", "yolov6s_opt_qat.py")
IMG, NC = 64, 16
SKIP = ("detect/stems",)
TOL = dict(atol=5e-4, rtol=1e-4)


def _cfg(config_cls):
    return small_config(config_cls, S_OPT_QAT)


def _x(batch=1, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (batch, IMG, IMG, 3)).astype(np.float32)


def _jax_quant(amax):
    """The port's ranges as the JAX ``quant`` collection."""
    out = {}
    for path, v in amax.items():
        node = out
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node["amax"] = jnp.asarray(float(v), jnp.float32)
    return out


@functools.lru_cache(maxsize=None)
def _files():
    jmodel = jax_build_model(_cfg(JaxConfig), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=41)
    model = build_model(_cfg(Config), num_classes=NC, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    amax = calibrate(model, [_x(2, seed=1) * 255.0], skip_patterns=SKIP)
    model.load_state_dict(quantize_variables(model.state_dict(), model))
    x = _x()
    fwd = DeployForward(model).eval()
    with quant_mode(model, amax, skip_patterns=SKIP):
        raw = export_onnx(fwd, (x,), input_names=["images"], output_names=["outputs"])
        with torch.no_grad():
            want = fwd(torch.from_numpy(x)).numpy()

    jvars = dict(jax_quantize_variables(dict(variables), 8))
    jvars["quant"] = _jax_quant(amax)

    def jax_fwd(images):
        head_out, _ = jmodel.apply(jvars, images, train=False)
        return jmodel.apply(jvars, head_out, method=jmodel.decode)

    try:
        set_quant_mode(True, skip_patterns=list(SKIP))
        jax_raw = jax_export_onnx(jax_fwd, (jnp.asarray(x),), input_names=["images"],
                                  output_names=["outputs"])
    finally:
        set_quant_mode(False)
    n_quantised = sum(not any(p in path for p in SKIP) for path in quant_paths(model).values())
    return x, want, to_qdq(raw), jax_to_qdq(jax_raw), n_quantised, len(quant_paths(model))


def _ops(data):
    from collections import Counter

    return Counter(n.op_type for n in parse_model(data).nodes)


def test_every_quantised_conv_input_is_rewritten():
    _, _, qdq, _, n_quantised, n_convs = _files()
    ops = _ops(qdq)
    assert n_convs > n_quantised > 20  # the stems are skipped
    assert ops["Conv"] == n_convs
    assert ops["QuantizeLinear"] == n_quantised
    assert ops["DequantizeLinear"] == n_quantised + n_convs  # + per-channel weights
    assert ops.get("Round", 0) == 0 and ops.get("Where", 0) == 0
    inits = parse_model(qdq).initializers
    weights = [n.inputs[1] for n in parse_model(qdq).nodes if n.op_type == "Conv"]
    producers = {o: n for n in parse_model(qdq).nodes for o in n.outputs}
    assert all(inits[producers[w].inputs[0]].dtype == np.int8 for w in weights)


def test_qdq_file_matches_fake_quant_forward():
    x, want, qdq, _, _, _ = _files()
    np.testing.assert_allclose(OnnxRunner(qdq)(x)[0], want, **TOL)


def test_remove_qdq_and_cache_match_jax(tmp_path):
    x, _, qdq, jax_qdq, _, _ = _files()
    plain, act_map = remove_qdq(qdq)
    jax_plain, jax_act_map = jax_remove_qdq(jax_qdq)
    ops = _ops(plain)
    assert ops.get("QuantizeLinear", 0) == 0 and ops.get("DequantizeLinear", 0) == 0
    np.testing.assert_allclose(OnnxRunner(plain)(x)[0], OnnxRunner(jax_plain)(x)[0], **TOL)
    assert sorted(act_map.values()) == sorted(jax_act_map.values())
    save_calib_cache_file(str(tmp_path / "port.cache"), act_map)
    lines = (tmp_path / "port.cache").read_text().splitlines()
    assert lines[0] == "TRT-8XXX-EntropyCalibration2" and len(lines) == len(act_map) + 1
    scales = sorted(struct.unpack("!f", bytes.fromhex(ln.rpartition(": ")[2]))[0]
                    for ln in lines[1:])
    want = sorted(struct.unpack("!f", bytes.fromhex(h))[0] for h in jax_act_map.values())
    assert scales == want
