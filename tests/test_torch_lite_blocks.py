"""The port's lite blocks (ConvBNHS and ConvBN with groups,
SEBlock, channel_shuffle, Lite_EffiBlockS1/S2, DPBlock, DarknetBlock,
CSPBlock) against the JAX package, on the CPU in fp32.

Each block gets the same seeded variables on both sides (JAX layout,
carried across by yolov6_tpu_torch/utils/weights.py: depthwise HWIO
``(k, k, 1, C)`` kernels as OIHW ``(C, 1, k, k)``, DPBlock's sibling BNs
``bn_1``/``bn_2``, SEBlock's biased ``conv1``/``conv2``) and the same input.
Tolerances: outputs and updated BN statistics rtol 1e-4 / atol 1e-5
(activations are O(1)), in the deploy form, in the train form with
eval-mode BN and in the train form with train-mode BN; the fold
(``fold_to_deploy``, DPBlock's biased convs included) against the JAX
``import_checkpoint(..., deploy=True)`` fold key for key, rtol 1e-6 / atol
1e-7 (both fold in float32 numpy); channel_shuffle exactly.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.layers import common as jcommon
from yolov6_tpu.utils.torch_import import import_checkpoint, native_variables_to_torch_state

from yolov6_tpu_torch.layers import common as tcommon
from yolov6_tpu_torch.layers.reparam import fold_to_deploy
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_csp_model import _nchw, _nhwc
from torch_port_utils import random_jax_variables

TOL = dict(rtol=1e-4, atol=1e-5)
FOLD_TOL = dict(rtol=1e-6, atol=1e-7)

# (id, JAX module(deploy), port module(deploy), input shape NHWC); widths are
# the lite configs' kinds: S2 halves mid and out, S1 keeps its input width
BLOCK_CASES = [
    ("ConvBNHS_dw_s2", lambda d: jcommon.ConvBNHS(16, 3, 2, 1, 16, deploy=d),
     lambda d: tcommon.ConvBNHS(16, 16, 3, 2, deploy=d, groups=16), (2, 12, 12, 16)),
    ("ConvBN_1x1", lambda d: jcommon.ConvBN(24, 1, 1, 0, deploy=d),
     lambda d: tcommon.ConvBN(16, 24, 1, 1, deploy=d), (2, 8, 8, 16)),
    ("Lite_EffiBlockS1", lambda d: jcommon.Lite_EffiBlockS1(24, 32, 1, deploy=d),
     lambda d: tcommon.Lite_EffiBlockS1(32, 24, 32, 1, deploy=d), (2, 8, 8, 32)),
    ("Lite_EffiBlockS2", lambda d: jcommon.Lite_EffiBlockS2(48, 64, 2, deploy=d),
     lambda d: tcommon.Lite_EffiBlockS2(32, 48, 64, 2, deploy=d), (2, 12, 12, 32)),
    ("DPBlock_5x5_s2", lambda d: jcommon.DPBlock(16, 5, 2, deploy=d),
     lambda d: tcommon.DPBlock(16, 5, 2, deploy=d), (2, 11, 11, 16)),
    ("DarknetBlock", lambda d: jcommon.DarknetBlock(16, 5, 1.0, deploy=d),
     lambda d: tcommon.DarknetBlock(24, 16, 5, 1.0, deploy=d), (2, 8, 8, 24)),
    ("CSPBlock", lambda d: jcommon.CSPBlock(24, 5, deploy=d),
     lambda d: tcommon.CSPBlock(48, 24, 5, deploy=d), (2, 8, 8, 48)),
]
FORMS = ["deploy", "train_eval_bn", "train_batch_bn"]


def _pair(jmake, tmake, shape, deploy, seed):
    jmod = jmake(deploy)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros(shape)))
    variables = random_jax_variables(shapes, seed=seed + 1)
    tmod = tmake(deploy)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmod, variables, tmod, x


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name,jmake,tmake,shape", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_lite_block_matches_jax(name, jmake, tmake, shape, form):
    jmod, variables, tmod, x = _pair(jmake, tmake, shape, form == "deploy", seed=len(name))
    train = form == "train_batch_bn"
    tmod.train(train)
    if train:
        want, updates = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    if train:
        stats = state_dict_from_jax({"batch_stats": updates["batch_stats"]})
        sd = tmod.state_dict()
        assert stats
        for key, value in stats.items():
            np.testing.assert_allclose(sd[key].numpy(), value.numpy(), err_msg=key, **TOL)


def test_se_block_matches_jax():
    """SEBlock: mean -> 1x1 conv -> ReLU -> 1x1 conv -> hard-sigmoid gate;
    the same in both forms (it has no BN)."""
    jmod, variables, tmod, x = _pair(lambda d: jcommon.SEBlock(24),
                                     lambda d: tcommon.SEBlock(24), (2, 6, 6, 24), True, seed=3)
    assert set(tmod.state_dict()) == {"conv1.weight", "conv1.bias", "conv2.weight", "conv2.bias"}
    assert tuple(tmod.conv1.weight.shape) == (6, 24, 1, 1)
    x = x * 4.0  # spread the gate's input over hard-sigmoid's ramp and both saturations
    with torch.no_grad():
        got = tmod(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(jmod.apply(variables, jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("groups", [2, 4])
def test_channel_shuffle_matches_jax(groups):
    """NCHW against the JAX NHWC shuffle on the same values: exactly."""
    x = np.random.default_rng(groups).standard_normal((2, 3, 5, 8 * groups)).astype(np.float32)
    want = np.asarray(jcommon.channel_shuffle(jnp.asarray(x), groups))
    got = _nhwc(tcommon.channel_shuffle(_nchw(x), groups))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,jmake,tmake,shape", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_lite_block_fold_matches_jax_fold(name, jmake, tmake, shape):
    """``fold_to_deploy`` of the train form against the JAX fold of the same
    variables (``import_checkpoint(..., deploy=True)``), key for key; the
    folded state loads into the deploy form with strict=True and its output
    equals the train form's eval-mode output. DPBlock's convs carry a bias
    of their own, which the fold keeps inside the BN's shift."""
    jmod, variables, tmod, x = _pair(jmake, tmake, shape, False, seed=7)
    got = fold_to_deploy(tmod.state_dict())
    jdeploy = jmake(True)
    spec = jax.eval_shape(lambda: jdeploy.init(jax.random.PRNGKey(0), jnp.zeros(shape)))
    want = state_dict_from_jax(import_checkpoint(native_variables_to_torch_state(variables), spec,
                                                 deploy=True))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), err_msg=key, **FOLD_TOL)
    deploy = tmake(True)
    deploy.load_state_dict(got, strict=True)
    tmod.eval()
    with torch.no_grad():
        np.testing.assert_allclose(deploy(_nchw(x)).numpy(), tmod(_nchw(x)).numpy(), **TOL)
    if name.startswith("DPBlock"):
        sd = tmod.state_dict()
        assert {"conv_dw_1.bias", "conv_pw_1.bias", "bn_1.weight", "bn_2.weight"} <= set(sd)
        assert float(sd["conv_dw_1.bias"].abs().max()) > 0  # the bias the fold must keep
        assert set(got) == {"conv_dw_1.weight", "conv_dw_1.bias", "conv_pw_1.weight",
                            "conv_pw_1.bias"}
