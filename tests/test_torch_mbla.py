"""The port's MBLA stage (BottleRep3, MBLABlock, the CSP graphs with
``stage_block_type="MBLABlock"`` of configs/mbla/) against the JAX package,
in both forms, on the CPU in fp32.

Both sides get the same seeded variables (JAX layout, carried across by
yolov6_tpu_torch/utils/weights.py, BottleRep3 alphas in [0.5, 1.5]) and the
same inputs; the tolerances are tests/test_torch_csp_model.py's. The blocks
take n = 1, 4 and 6, so that ``n_list`` takes each of its forms: ``[0, 1]``
(n // 2 ≤ 1), ``[0, 1, 2]`` (n // 2 a power of two) and ``[0, 2, 3]`` (not).
Small S-MBLA (depth 0.1, width 0.125, ``conv_silu``, DFL) at 128 px: its
train-mode forward is held against the JAX forward in float64
(``torch_port_utils.jax_in_float64``), as small M's and L's are.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.layers import common as jcommon
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig
from yolov6_tpu.utils.torch_import import import_checkpoint, native_variables_to_torch_state

from yolov6_tpu_torch.layers import common as tcommon
from yolov6_tpu_torch.layers.reparam import fold_to_deploy
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_csp_model import TOL, _head_close, _nchw, _stats_close, check_block_matches_jax
from torch_port_utils import MBLA_CONFIGS, jax_in_float64, random_jax_variables, small_config

IMG, NC = 128, 3
J_REP, J_RELU, J_SILU = jcommon.RepVGGBlock, jcommon.ConvBNReLU, jcommon.ConvBNSiLU
T_REP, T_RELU, T_SILU = tcommon.RepVGGBlock, tcommon.ConvBNReLU, tcommon.ConvBNSiLU

# (id, JAX module(deploy), port module(deploy), input shape NHWC)
BLOCK_CASES = [
    ("BottleRep3_repvgg_alpha", lambda d: jcommon.BottleRep3(8, J_REP, True, deploy=d),
     lambda d: tcommon.BottleRep3(8, 8, T_REP, True, deploy=d), (2, 8, 8, 8)),
    ("BottleRep3_conv_silu_no_residual", lambda d: jcommon.BottleRep3(12, J_SILU, True, deploy=d),
     lambda d: tcommon.BottleRep3(8, 12, T_SILU, True, deploy=d), (2, 8, 8, 8)),
    ("MBLABlock_n1_conv_silu", lambda d: jcommon.MBLABlock(16, 1, 0.5, J_SILU, deploy=d),
     lambda d: tcommon.MBLABlock(12, 16, 1, 0.5, T_SILU, deploy=d), (2, 8, 8, 12)),
    ("MBLABlock_n4_repvgg", lambda d: jcommon.MBLABlock(16, 4, 0.5, J_REP, deploy=d),
     lambda d: tcommon.MBLABlock(8, 16, 4, 0.5, T_REP, deploy=d), (2, 8, 8, 8)),
    ("MBLABlock_n6_conv_silu", lambda d: jcommon.MBLABlock(16, 6, 0.5, J_SILU, deploy=d),
     lambda d: tcommon.MBLABlock(16, 16, 6, 0.5, T_SILU, deploy=d), (2, 8, 8, 16)),
    ("MBLABlock_n6_conv_relu_e2/3", lambda d: jcommon.MBLABlock(24, 6, float(2) / 3, J_RELU,
                                                                 deploy=d),
     lambda d: tcommon.MBLABlock(8, 24, 6, float(2) / 3, T_RELU, deploy=d), (2, 8, 8, 8)),
]


@pytest.mark.parametrize("form", ["deploy", "train"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_mbla_block_matches_jax(case, form):
    """Deploy form: the output. Train form: train mode (outputs and updated
    BN statistics), then eval mode."""
    check_block_matches_jax(case, form == "deploy")


@pytest.mark.parametrize("n,n_list", [(1, [0, 1]), (2, [0, 1]), (4, [0, 1, 2]), (6, [0, 2, 3]),
                                      (8, [0, 2, 4]), (10, [0, 4, 5])])
def test_mbla_branches(n, n_list):
    """``m.{k}`` holds ``n_list[k + 1]`` BottleRep3s, each with its alpha, and
    ``cv1`` writes one chunk of the hidden width for each entry of ``n_list``."""
    block = tcommon.MBLABlock(8, 16, n, 0.5, T_SILU, deploy=False)
    assert [len(chain) for chain in block.m] == n_list[1:]
    assert block.cv1.conv.out_channels == len(n_list) * 8
    assert block.cv2.conv.in_channels == (len(n_list) + sum(n_list)) * 8
    assert all(unit.alpha is not None for chain in block.m for unit in chain)


def _build_pair(deploy, seed):
    """Small S-MBLA on both sides with the same seeded variables."""
    jmodel = jax_build_model(small_config(JaxConfig, MBLA_CONFIGS["s"]), num_classes=NC,
                             deploy=deploy)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=seed)
    model = build_model(small_config(Config, MBLA_CONFIGS["s"]), num_classes=NC, deploy=deploy,
                        device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def _images(seed):
    return np.random.default_rng(seed).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)


def test_small_s_mbla_deploy_matches_jax():
    """Deploy graph: every head map and the DFL decode."""
    jmodel, variables, model = _build_pair(True, seed=50)
    x = _images(51)
    head_j, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    preds_j = np.asarray(jmodel.apply(variables, head_j, method=jmodel.decode))
    assert model.use_dfl and model.reg_max == 16
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
        preds_t = model.decode(head_t).numpy()
    _head_close(head_t, head_j)
    assert preds_t.shape == preds_j.shape == (2, 16 * 16 + 8 * 8 + 4 * 4, 5 + NC)
    np.testing.assert_allclose(preds_t[..., :4], preds_j[..., :4], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(preds_t[..., 5:], preds_j[..., 5:], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def small_train():
    jmodel, variables, model = _build_pair(False, seed=52)
    return jmodel, variables, model, _images(53)


def test_small_s_mbla_train_matches_jax(small_train):
    """Train mode against the JAX forward in float64: every head map and
    every updated BN statistic; the state dict's keys those of the JAX
    export (plus each BN's ``num_batches_tracked``)."""
    jmodel, variables, model, x = small_train

    def apply_train(v, a):
        return jmodel.apply(v, a, train=True, mutable=["batch_stats"])

    (head_64, _), updates_64 = jax_in_float64(apply_train)(variables, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _head_close(head_t, head_64)
    _stats_close(model, updates_64["batch_stats"])
    model.load_state_dict(state_dict_from_jax(variables), strict=True)

    native = native_variables_to_torch_state(variables)
    want = {k.replace(".upsample.bias", ".upsample.upsample_transpose.bias") for k in native}
    got = set(model.state_dict())
    assert got - {k for k in got if k.endswith(".num_batches_tracked")} == want
    assert "backbone.ERBlock_2.1.m.0.0.conv3.block.bn.running_var" in got
    # one BottleRep3 in each of the 4 backbone and 4 neck MBLABlocks at depth 0.1
    assert sorted(k for k in got if k.endswith(".alpha"))[0] == "backbone.ERBlock_2.1.m.0.0.alpha"
    assert len([k for k in got if k.endswith(".alpha")]) == 8


def test_small_s_mbla_fold_matches_jax_fold(small_train):
    """``fold_to_deploy`` (the MBLA ConvModules' conv+BN and BottleRep3's
    ConvBNSiLUs) against the JAX fold, key for key; the folded state loads
    into the deploy graph with strict=True and its forward equals the train
    model's eval forward."""
    _, variables, model, x = small_train
    got = fold_to_deploy(state_dict_from_jax(variables))
    jdeploy = jax_build_model(small_config(JaxConfig, MBLA_CONFIGS["s"]), num_classes=NC,
                              deploy=True)
    spec = jax.eval_shape(
        lambda: jdeploy.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    want = state_dict_from_jax(import_checkpoint(native_variables_to_torch_state(variables), spec,
                                                 training_mode="conv_silu", deploy=True))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    deploy = build_model(small_config(Config, MBLA_CONFIGS["s"]), num_classes=NC, deploy=True,
                         device="cpu")
    deploy.load_state_dict(got, strict=True)
    model.eval()
    with torch.no_grad():
        want_h, _ = model(_nchw(x))
        got_h, _ = deploy(_nchw(x))
    model.train()
    for key in ("cls", "reg"):
        for mg, mw in zip(got_h[key], want_h[key]):
            np.testing.assert_allclose(mg.numpy(), mw.numpy(), **TOL)


@pytest.mark.parametrize("name,count", [("s", 11_609_008), ("m", 26_059_424),
                                        ("l", 46_273_936), ("x", 78_829_350)])
def test_full_width_mbla_parameter_count_matches_jax(name, count):
    """Full-width MBLA deploy graphs, built and not run: the port's parameter
    count equals the JAX package's (its variables' shapes by
    ``jax.eval_shape``, nothing compiled), which is ``count``; the train
    graph folds into the deploy graph with strict=True."""
    jmodel = jax_build_model(JaxConfig.fromfile(MBLA_CONFIGS[name]), num_classes=80, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    cfg = Config.fromfile(MBLA_CONFIGS[name])
    deploy = build_model(cfg, num_classes=80, deploy=True, device="cpu")
    got = sum(p.numel() for p in deploy.parameters())
    assert got == want == count
    train = build_model(cfg, num_classes=80, deploy=False, device="cpu")
    deploy.load_state_dict(fold_to_deploy(train.state_dict()), strict=True)
