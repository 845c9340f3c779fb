"""The port's train-form blocks and model, its train weights carrier and its
fold against the JAX package.

Both sides get the same seeded train variables (params and batch_stats, JAX
layout, carried across by yolov6_tpu_torch/utils/weights.py) and the same
inputs, on the CPU in fp32. Tolerances: train- and eval-mode outputs and the
updated BN statistics rtol 1e-4 / atol 1e-5 (activations are O(1)); the fold
against the JAX fold rtol 1e-6 / atol 1e-7 (both fold in float32 numpy); the
folded deploy forward against the train model's eval forward rtol 1e-4 /
atol 1e-5.
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

from torch_port_utils import S_CONFIG, random_jax_variables, small_n_config, small_s_config

TOL = dict(rtol=1e-4, atol=1e-5)
IMG, NC = 64, 3


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _stats_close(port_module, jax_stats):
    """Every running_mean/running_var of the port module equals the JAX
    batch_stats leaf it came from."""
    want = state_dict_from_jax({"batch_stats": jax_stats})
    got = port_module.state_dict()
    assert want and set(want) <= set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), err_msg=key, **TOL)


# (id, JAX module, port module, input shapes NHWC, inputs passed as one list)
BLOCK_CASES = [
    ("ConvBNReLU_3x3_s2", lambda: jcommon.ConvBNReLU(16, 3, 2),
     lambda: tcommon.ConvBNReLU(8, 16, 3, 2, deploy=False), [(2, 12, 12, 8)], False),
    ("ConvBNSiLU_1x1", lambda: jcommon.ConvBNSiLU(16, 1, 1),
     lambda: tcommon.ConvBNSiLU(8, 16, 1, 1, deploy=False), [(2, 12, 12, 8)], False),
    ("RepVGGBlock_s2", lambda: jcommon.RepVGGBlock(16, 3, 2),
     lambda: tcommon.RepVGGBlock(8, 16, 3, 2, deploy=False), [(2, 12, 12, 8)], False),
    ("RepVGGBlock_identity", lambda: jcommon.RepVGGBlock(8, 3, 1),
     lambda: tcommon.RepVGGBlock(8, 8, 3, 1, deploy=False), [(2, 10, 10, 8)], False),
    ("RepBlock_n3", lambda: jcommon.RepBlock(16, n=3),
     lambda: tcommon.RepBlock(8, 16, n=3, deploy=False), [(2, 12, 12, 8)], False),
    ("SimCSPSPPF", lambda: jcommon.SimCSPSPPF(16, 5),
     lambda: tcommon.SimCSPSPPF(8, 16, deploy=False), [(2, 9, 9, 8)], False),
    ("BiFusion", lambda: jcommon.BiFusion(8),
     lambda: tcommon.BiFusion((12, 6), 8, deploy=False),
     [(2, 4, 4, 8), (2, 8, 8, 12), (2, 16, 16, 6)], True),
]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_train_block_matches_jax(case):
    """Train mode (outputs and the updated BN statistics), then eval mode."""
    _, make_jax, make_port, in_shapes, as_list = case
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal(s).astype(np.float32) for s in in_shapes]
    jmod = make_jax()
    jargs = ([[jnp.asarray(x) for x in xs]] if as_list else [jnp.asarray(x) for x in xs])
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs))
    variables = random_jax_variables(shapes, seed=12)
    want_train, updates = jmod.apply(variables, *jargs, train=True, mutable=["batch_stats"])
    want_eval = jmod.apply(variables, *jargs, train=False)

    port = make_port()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    targs = [[_nchw(x) for x in xs]] if as_list else [_nchw(x) for x in xs]
    port.train()
    with torch.no_grad():
        got_train = _nhwc(port(*targs))
    np.testing.assert_allclose(got_train, np.asarray(want_train), **TOL)
    _stats_close(port, updates["batch_stats"])

    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.eval()
    with torch.no_grad():
        got_eval = _nhwc(port(*targs))
    np.testing.assert_allclose(got_eval, np.asarray(want_eval), **TOL)


@pytest.fixture(scope="module")
def small_train():
    """The small S graph in its train form on both sides, with the same
    seeded variables, and one batch of inputs."""
    jmodel = jax_build_model(small_s_config(JaxConfig), num_classes=NC, deploy=False)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    )
    variables = random_jax_variables(shapes, seed=13)
    model = build_model(small_s_config(Config), num_classes=NC, deploy=False, device="cpu")
    x = np.random.default_rng(14).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    return jmodel, variables, model, x


def _head_close(head_t, head_j):
    for key in ("cls", "reg"):
        for mt, mj in zip(head_t[key], head_j[key]):
            np.testing.assert_allclose(_nhwc(mt), np.asarray(mj), **TOL)


def test_train_model_matches_jax(small_train):
    """Train mode: every head map and every updated BN statistic; then eval
    mode: every head map."""
    jmodel, variables, model, x = small_train
    apply_train = jax.jit(lambda v, a: jmodel.apply(v, a, train=True, mutable=["batch_stats"]))
    (head_j, _), updates = apply_train(variables, jnp.asarray(x))
    head_e, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))

    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _head_close(head_t, head_j)
    _stats_close(model, updates["batch_stats"])

    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _head_close(head_t, head_e)
    assert model.training is False and build_model(
        small_s_config(Config), num_classes=NC, deploy=False, device="cpu").training


def test_small_n_train_model_matches_jax():
    """Small N in its train form: train-mode head maps and BN statistics,
    then eval-mode head maps."""
    jmodel = jax_build_model(small_n_config(JaxConfig), num_classes=NC, deploy=False)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=17)
    x = np.random.default_rng(18).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    (head_j, _), updates = jax.jit(
        lambda v, a: jmodel.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    head_e, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))

    model = build_model(small_n_config(Config), num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _head_close(head_t, head_j)
    _stats_close(model, updates["batch_stats"])
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _head_close(head_t, head_e)


def test_train_state_dict_keys_match_jax_export(small_train):
    """The port's train state dict has the keys that the JAX package's
    ``native_variables_to_torch_state`` writes, plus each BN's
    ``num_batches_tracked``. One difference of naming: that function puts a
    Transpose block's bias at ``X.upsample.bias`` (its ``import_checkpoint``
    reads either), where the module holds it at
    ``X.upsample.upsample_transpose.bias``, as upstream's does."""
    _, variables, model, _ = small_train
    native = native_variables_to_torch_state(variables)
    want = {k.replace(".upsample.bias", ".upsample.upsample_transpose.bias") for k in native}
    got = set(model.state_dict())
    tracked = {k for k in got if k.endswith(".num_batches_tracked")}
    assert got - tracked == want
    assert tracked == {k.replace(".running_mean", ".num_batches_tracked")
                       for k in want if k.endswith(".running_mean")}
    sd = state_dict_from_jax(variables)
    assert set(sd) == got
    assert all(int(sd[k]) == 0 and sd[k].dtype == torch.int64 for k in tracked)
    assert sum("rbr_identity.weight" in k for k in got) > 0


def test_fold_matches_jax_fold(small_train):
    """``fold_to_deploy`` against the JAX fold (``import_checkpoint(...,
    deploy=True)`` of ``native_variables_to_torch_state``), key for key."""
    _, variables, _, _ = small_train
    got = fold_to_deploy(state_dict_from_jax(variables))
    jdeploy = jax_build_model(small_s_config(JaxConfig), num_classes=NC, deploy=True)
    spec = jax.eval_shape(
        lambda: jdeploy.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    )
    folded = import_checkpoint(native_variables_to_torch_state(variables), spec, deploy=True)
    want = state_dict_from_jax(folded)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_folded_deploy_model_matches_train_eval_forward(small_train):
    """The folded state loads into the deploy graph with strict=True, and its
    forward equals the train model's eval-mode forward."""
    _, variables, model, x = small_train
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    deploy = build_model(small_s_config(Config), num_classes=NC, deploy=True, device="cpu")
    deploy.load_state_dict(fold_to_deploy(model.state_dict()), strict=True)
    model.eval()
    with torch.no_grad():
        want, _ = model(_nchw(x))
        got, _ = deploy(_nchw(x))
    for key in ("cls", "reg"):
        for mg, mw in zip(got[key], want[key]):
            np.testing.assert_allclose(mg.numpy(), mw.numpy(), rtol=1e-4, atol=1e-5)


def test_train_graph_full_width_s():
    """Full-width YOLOv6-S in its train form (built, not run): the branch
    structure and the parameter count before and after the fold."""
    cfg = Config.fromfile(S_CONFIG)
    model = build_model(cfg, num_classes=80, deploy=False, device="cpu")
    sd = model.state_dict()
    assert sd["backbone.stem.rbr_dense.conv.weight"].shape == (32, 3, 3, 3)
    assert sd["backbone.stem.rbr_1x1.conv.weight"].shape == (32, 3, 1, 1)
    assert "backbone.stem.rbr_identity.weight" not in sd  # 3 -> 32 channels, stride 2
    assert "backbone.ERBlock_2.1.conv1.rbr_identity.running_var" in sd
    assert sd["detect.stems.0.block.bn.weight"].shape == (64,)
    deploy = build_model(cfg, num_classes=80, deploy=True, device="cpu")
    folded = fold_to_deploy(sd)
    deploy.load_state_dict(folded, strict=True)
    assert 18.4e6 < sum(v.numel() for v in folded.values()) < 18.6e6
