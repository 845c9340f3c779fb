"""The port's ONNX export (yolov6_tpu_torch/export/onnx_export.py, which walks
the core-ATen graph of ``torch.export``) against the port's own forward and
the JAX package's ONNX file, on the CPU.

For small S (RepVGG, the ``Transpose`` block's transposed conv), small M
(CSP, DFL decode), small N6 (P6, four levels), small S-MBLA and Lite-S at
full width (the lite blocks, SE, hard-swish): the deploy graph plus decode
over NHWC fp32 images is exported once per module from seeded JAX variables
carried across by ``state_dict_from_jax``, then

- run through the port's ``OnnxRunner``: equal to the port's fp32 forward
  plus decode within atol 5e-4 / rtol 1e-4 (``tools/export.py --check``'s
  tolerance);
- run through the JAX package's ``OnnxRunner``: equal to the JAX package's
  ONNX file of the same weights, run through the same runner, at the same
  tolerance; both files take NHWC ``images`` and give ``outputs``.
"""

import functools
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.export.onnx_export import export_onnx as jax_export_onnx
from yolov6_tpu.export.onnx_numpy import OnnxRunner as JaxOnnxRunner
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.export.onnx_export import export_onnx
from yolov6_tpu_torch.export.onnx_numpy import OnnxRunner
from yolov6_tpu_torch.export.onnx_proto import parse_model
from yolov6_tpu_torch.export.torch_export import DeployForward
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import (
    MBLA_CONFIGS, P6_CONFIGS, REPO_ROOT, random_jax_variables, random_lite_variables,
    small_config, small_m_config, small_s_config,
)

NC, BATCH = 16, 2
TOL = dict(atol=5e-4, rtol=1e-4)
LITE_S = os.path.join(REPO_ROOT, "configs", "yolov6_lite", "yolov6_lite_s.py")
# name -> (config at test size, image size, lite variables)
FAMILIES = {
    "s": (small_s_config, 64, False),
    "m_dfl": (small_m_config, 64, False),
    "n6": (lambda c: small_config(c, P6_CONFIGS["n6"]), 128, False),
    "s_mbla": (lambda c: small_config(c, MBLA_CONFIGS["s"]), 64, False),
    "lite_s": (lambda c: c.fromfile(LITE_S), 64, True),
}


@functools.lru_cache(maxsize=None)
def _family(name):
    """The family's port model and JAX twin from one set of seeded
    variables, both exported to ONNX, and the example images."""
    make_cfg, img, lite = FAMILIES[name]
    jmodel = jax_build_model(make_cfg(JaxConfig), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False))
    variables = (random_lite_variables if lite else random_jax_variables)(shapes, seed=21)
    model = build_model(make_cfg(Config), num_classes=NC, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = np.random.default_rng(1).uniform(0, 1, (BATCH, img, img, 3)).astype(np.float32)

    def jax_fwd(images):
        head_out, _ = jmodel.apply(variables, images, train=False)
        return jmodel.apply(variables, head_out, method=jmodel.decode)

    port = export_onnx(DeployForward(model), (x,), input_names=["images"],
                       output_names=["outputs"])
    jax_file = jax_export_onnx(jax_fwd, (jnp.asarray(x),), input_names=["images"],
                               output_names=["outputs"])
    return model, x, port, jax_file


@pytest.mark.parametrize("name", list(FAMILIES))
def test_onnx_matches_port_forward(name):
    model, x, port, _ = _family(name)
    m = parse_model(port)
    assert m.opset == 13
    assert [n for n, _, _ in m.inputs] == ["images"] and m.inputs[0][2] == x.shape
    assert [n for n, _, _ in m.outputs] == ["outputs"]
    got = OnnxRunner(port)(x)[0]
    with torch.no_grad():
        want = DeployForward(model)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (BATCH, want.shape[1], 5 + NC)
    assert np.ptp(want[..., 5:]) > 0.1  # the class scores vary: a wiring check
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_onnx_matches_jax_onnx(name):
    _, x, port, jax_file = _family(name)
    runner_port, runner_jax = JaxOnnxRunner(port), JaxOnnxRunner(jax_file)
    got, want = runner_port(x)[0], runner_jax(x)[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_transposed_conv_is_matmul_depth_to_space():
    """The ``Transpose`` block converts as the JAX package computes it (no
    ConvTranspose node, which neither runner executes): a MatMul with a
    constant [c, 4·o] weight."""
    _, _, port, _ = _family("s")
    m = parse_model(port)
    assert not any(n.op_type == "ConvTranspose" for n in m.nodes)
    mats = [n for n in m.nodes if n.op_type == "MatMul"]
    assert len(mats) >= 2 and all(n.inputs[1] in m.initializers for n in mats[:2])
