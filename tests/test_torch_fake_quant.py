"""The port's fake quantisation (yolov6_tpu_torch/quant/fake_quant.py) against
the JAX package's (yolov6_tpu/quant/fake_quant.py), on the CPU.

- ``fake_quant`` and ``fake_quant_per_channel`` equal JAX's bit for bit on
  fp32 inputs: values on exact .5 ties of ``x / scale``, values outside the
  range, ``amax = 0`` (the skip), 8 and 4 bits. On bf16 inputs they agree
  within one bf16 ulp of the output.
- The straight-through gradient equals ``jax.grad``'s exactly: the
  incoming gradient inside the clip range, zero outside, half on the
  range's ends (the clip's maximum/minimum split a tie).
- The weight step on a small ``yolov6s_opt_qat`` deploy graph (RealVGG
  convs, the ``Transpose`` blocks' 2x2 kernels, the head) equals JAX's
  ``quantize_variables`` carried over by ``state_dict_from_jax``, bit for
  bit, with and without skip patterns.

None of these calls sets the JAX package's global quant mode.
"""

import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.quant.fake_quant import fake_quant as jax_fake_quant
from yolov6_tpu.quant.fake_quant import fake_quant_per_channel as jax_fake_quant_per_channel
from yolov6_tpu.quant.ptq import quantize_variables as jax_quantize_variables
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.quant.fake_quant import (
    conv_weight_paths, fake_quant, fake_quant_per_channel, quantize_conv_weights,
)
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import REPO_ROOT, random_jax_variables, small_config

S_OPT_QAT = os.path.join(REPO_ROOT, "configs", "repopt", "yolov6s_opt_qat.py")
BF16_ULP = 2.0 ** -7  # one bf16 ulp relative to the value's binade


def _inputs(amax, num_bits, seed=0):
    """Normal values spread past ``amax``, plus every exact tie
    ``(k + 0.5) * scale`` of a stretch of the range and the range's ends."""
    qmax = 2.0 ** (num_bits - 1) - 1
    scale = np.float32(max(amax, 1e-12)) / np.float32(qmax)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(4000).astype(np.float32) * np.float32(amax)
    ties = (np.arange(-qmax - 1, qmax, dtype=np.float32) + np.float32(0.5)) * scale
    ends = np.array([-(qmax + 1) * scale, qmax * scale, 3 * amax, -3 * amax], np.float32)
    return np.concatenate([x, ties, ends]).astype(np.float32)


@pytest.mark.parametrize("num_bits", [8, 4])
@pytest.mark.parametrize("amax", [2.5, 0.0371, 0.0])
def test_fake_quant_bit_equal_fp32(amax, num_bits):
    x = _inputs(amax if amax > 0 else 1.0, num_bits)
    want = np.asarray(jax_fake_quant(jnp.asarray(x), jnp.float32(amax), num_bits))
    got = fake_quant(torch.from_numpy(x), torch.tensor(amax, dtype=torch.float32), num_bits)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if amax == 0.0:
        np.testing.assert_array_equal(got.numpy(), x)  # the skip returns x
    else:
        assert len(np.unique(got.numpy())) <= 2 ** num_bits


@pytest.mark.parametrize("num_bits", [8, 4])
def test_fake_quant_bf16_within_one_ulp(num_bits):
    """A bf16 input is quantised in fp32 and returned in bf16 (JAX promotes
    it against the fp32 amax); the two agree within one bf16 ulp."""
    x = _inputs(1.7, num_bits, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_fake_quant(xb, jnp.float32(1.7), num_bits).astype(jnp.float32))
    got = fake_quant(torch.from_numpy(x).bfloat16(), torch.tensor(1.7), num_bits)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= BF16_ULP * np.abs(want) + 1e-30).all(), float(err.max())


@pytest.mark.parametrize("num_bits", [8, 4])
@pytest.mark.parametrize("axis", [0, 1])
def test_fake_quant_per_channel_bit_equal(num_bits, axis):
    """OIHW weights along ``axis``; the JAX function gets the same tensor
    with the channel axis last (its HWIO layout), one channel all zero."""
    rng = np.random.default_rng(3 + axis)
    w = (rng.standard_normal((6, 5, 3, 3)) * rng.uniform(0.01, 2.0, (6, 1, 1, 1)) if axis == 0
         else rng.standard_normal((5, 6, 2, 2)) * rng.uniform(0.01, 2.0, (1, 6, 1, 1)))
    w = w.astype(np.float32)
    w[(slice(None),) * axis + (2,)] = 0.0
    want = np.asarray(jax_fake_quant_per_channel(jnp.asarray(np.moveaxis(w, axis, -1)),
                                                 num_bits, axis=-1))
    got = fake_quant_per_channel(torch.from_numpy(w), num_bits, axis=axis)
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), axis, -1), want)
    wb = jnp.asarray(np.moveaxis(w, axis, -1)).astype(jnp.bfloat16)
    want_b = np.asarray(jax_fake_quant_per_channel(wb, num_bits, axis=-1).astype(jnp.float32))
    got_b = fake_quant_per_channel(torch.from_numpy(w).bfloat16(), num_bits, axis=axis)
    err = np.abs(np.moveaxis(got_b.float().numpy(), axis, -1) - want_b)
    assert (err <= BF16_ULP * np.abs(want_b) + 1e-30).all(), float(err.max())


@pytest.mark.parametrize("num_bits", [8, 4])
def test_straight_through_gradient_equals_jax_grad(num_bits):
    amax = 1.3
    x = _inputs(amax, num_bits, seed=2)
    g = np.random.default_rng(5).uniform(0.5, 1.5, x.shape).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jax_fake_quant(v, jnp.float32(amax), num_bits) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (fake_quant(xt, torch.tensor(amax), num_bits) * torch.from_numpy(g)).sum().backward()
    got = xt.grad.numpy()
    np.testing.assert_array_equal(got, want)
    qmax = 2.0 ** (num_bits - 1) - 1
    v = x / (np.float32(amax) / np.float32(qmax))
    assert (got[(v > qmax) | (v < -qmax - 1)] == 0).all()
    inside = (v < qmax) & (v > -qmax - 1)
    assert inside.sum() > 1000 and np.allclose(got[inside], g[inside], rtol=1e-6)
    assert ((v == qmax) | (v == -qmax - 1)).any()  # the ends: half, as the tie of a clip


def _s_opt_qat_deploy(seed=11):
    jcfg = small_config(JaxConfig, S_OPT_QAT)
    jmodel = jax_build_model(jcfg, num_classes=3, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    variables = random_jax_variables(shapes, seed=seed)
    model = build_model(small_config(Config, S_OPT_QAT), num_classes=3, deploy=True,
                        device="cpu")
    return variables, model


@pytest.mark.parametrize("skip", [(), ("detect/", "ERBlock_3", "upsample1"),
                                  ("detect.stems.0.conv", "detect.cls_preds.0")])
def test_weight_step_equals_jax_quantize_variables(skip):
    """The third case is the configs' dotted ``sensitive_layers_list`` form,
    which matches no JAX path: it skips nothing in either package."""
    variables, model = _s_opt_qat_deploy()
    sd = state_dict_from_jax(variables)
    model.load_state_dict(sd, strict=True)
    want = state_dict_from_jax(jax_quantize_variables(dict(variables), 8, list(skip)))
    got = quantize_conv_weights(model.state_dict(), 8, skip, model)
    assert set(got) == set(want)
    paths = conv_weight_paths(model)
    transposes = [k for k in paths if "upsample_transpose" in k]
    assert len(transposes) == 2 and all(paths[k][1] == 1 for k in transposes)
    changed = 0
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[key].numpy(), err_msg=key)
        changed += not torch.equal(value, sd[key])
    skipped = [k for k in paths if any(p in paths[k][0] for p in skip)]
    assert changed == len(paths) - len(skipped)
    if skip and "." in skip[0]:
        assert not skipped
    elif skip:
        assert any("upsample_transpose" in k for k in skipped) and len(skipped) > 5


def test_weight_step_refuses_another_graphs_state_dict():
    _, model = _s_opt_qat_deploy()
    sd = dict(model.state_dict())
    sd["stray.conv.weight"] = torch.zeros(2, 2, 3, 3)
    with pytest.raises(ValueError, match="no conv weight"):
        quantize_conv_weights(sd, 8, (), model)
