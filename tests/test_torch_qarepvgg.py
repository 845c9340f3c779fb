"""The port's QARepVGG blocks (V1 and V2: ``get_block('qarepvgg')`` and
``'qarepvggv2'``), their fold, and the QARepVGG configs
(configs/qarepvgg/yolov6{n,s,m}_qa.py) against the JAX package, on the CPU
in fp32.

Blocks: the train form (a 3x3 conv+BN, a bare 1x1 conv, the input itself
and, in V2, a 3x3 average pool, both only when in == out and the stride is
1, summed, then one BN) in train mode (outputs and updated BN statistics)
and eval mode, and the deploy form, rtol 1e-4 / atol 1e-5; the fold
against the JAX fold rtol 1e-6 / atol 1e-7 (both fold in float32 numpy).
The JAX import fold (``import_checkpoint``) decides the identity and
average branches by the channel counts alone, so for the stride-2 in == out
case, which no shipped graph has, the port's fold is held against the JAX
``qarepvgg_fold`` under the block's own rule, and against the JAX block's
train form.

Graphs: small N-QA (V1 blocks: its config's mode switched to ``qarepvgg``,
depth 0.1, width 0.0625), S-QA and M-QA (V2, depth 0.1, width 0.125) at 64
px, with the head-map and decode tolerances of tests/test_torch_csp_model.py;
M-QA's train-mode forward is held against the JAX forward in float64
(``torch_port_utils.jax_in_float64``), as M's is. The full configs'
parameter counts equal the JAX package's.
"""

import functools
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.layers import common as jcommon
from yolov6_tpu.layers import reparam as jreparam
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig
from yolov6_tpu.utils.torch_import import import_checkpoint, native_variables_to_torch_state

from yolov6_tpu_torch.layers import common as tcommon
from yolov6_tpu_torch.layers.reparam import fold_to_deploy
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_csp_model import _nchw, _nhwc, _stats_close
from torch_port_utils import REPO_ROOT, jax_in_float64, random_jax_variables, small_config

TOL = dict(rtol=1e-4, atol=1e-5)
FOLD_TOL = dict(rtol=1e-6, atol=1e-7)
IMG, NC = 64, 3
QA_CONFIGS = {k: os.path.join(REPO_ROOT, "configs", "qarepvgg", f"yolov6{k}_qa.py")
              for k in ("n", "s", "m")}
# (deploy, train) parameter counts of the JAX package's graphs, 80 classes
PARAMS = {"n": (4_646_940, 5_052_732), "s": (18_537_276, 20_136_316),
          "m": (34_855_924, 37_722_772)}
VERSIONS = {"v1": (jcommon.QARepVGGBlock, tcommon.QARepVGGBlock),
            "v2": (jcommon.QARepVGGBlockV2, tcommon.QARepVGGBlockV2)}
# (id, in, out, stride): the identity (and V2's average) branch only in the
# first; the last is in == out at stride 2, which has neither
BLOCK_SHAPES = [("in_eq_out_s1", 16, 16, 1), ("in_ne_out_s1", 16, 24, 1),
                ("in_ne_out_s2", 16, 24, 2), ("in_eq_out_s2", 16, 16, 2)]


def _block_pair(version, cin, cout, stride, deploy, seed):
    jcls, tcls = VERSIONS[version]
    jmod = jcls(cout, 3, stride, deploy=deploy)
    x = np.random.default_rng(seed).standard_normal((2, 10, 10, cin)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = random_jax_variables(shapes, seed=seed + 1)
    tmod = tcls(cin, cout, 3, stride, deploy=deploy)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmod, variables, tmod, x


@pytest.mark.parametrize("form", ["deploy", "train"])
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=[s[0] for s in BLOCK_SHAPES])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_qarepvgg_block_matches_jax(version, shape, form):
    """Deploy form: the output. Train form: train mode (output and the
    updated BN statistics of ``rbr_dense.bn`` and the post-sum ``bn``), then
    eval mode. The 1x1 branch is a bare conv (``rbr_1x1.weight``)."""
    name, cin, cout, stride = shape
    jmod, variables, tmod, x = _block_pair(version, cin, cout, stride, form == "deploy", seed=5)
    assert tmod.has_identity == (name == "in_eq_out_s1")
    assert tmod.has_avg == (tmod.has_identity and version == "v2")
    if form == "train":
        assert {"rbr_1x1.weight", "bn.weight", "rbr_dense.bn.weight"} <= set(tmod.state_dict())
        want, updates = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        tmod.train()
        with torch.no_grad():
            np.testing.assert_allclose(_nhwc(tmod(_nchw(x))), np.asarray(want), **TOL)
        _stats_close(tmod, updates["batch_stats"])
        tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    tmod.eval()
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=[s[0] for s in BLOCK_SHAPES])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_qarepvgg_fold_matches_jax(version, shape):
    """``fold_to_deploy`` (the block as its graph) against the JAX
    ``qarepvgg_fold`` under the block's rule (the average kernel, the
    identity, the post-sum BN folded into the biased kernel), and, where the
    channel rule agrees with it, against ``import_checkpoint``; the deploy
    form loaded with the fold equals the train form's eval output and the
    JAX train form's. Without the graph a block with in == out raises."""
    name, cin, cout, stride = shape
    jmod, variables, tmod, x = _block_pair(version, cin, cout, stride, False, seed=9)
    sd = tmod.state_dict()
    got = fold_to_deploy(sd, tmod)
    assert set(got) == {"rbr_reparam.weight", "rbr_reparam.bias"}

    def bn(prefix):
        return dict(gamma=sd[f"{prefix}.weight"].numpy(), beta=sd[f"{prefix}.bias"].numpy(),
                    mean=sd[f"{prefix}.running_mean"].numpy(),
                    var=sd[f"{prefix}.running_var"].numpy(), eps=1e-3)

    hwio = lambda t: np.transpose(t.numpy(), (2, 3, 1, 0))  # noqa: E731
    kernel, bias = jreparam.qarepvgg_fold(
        hwio(sd["rbr_dense.conv.weight"]), bn("rbr_dense.bn"), hwio(sd["rbr_1x1.weight"]),
        bn("bn"), tmod.has_identity, cout, has_avg=tmod.has_avg)
    np.testing.assert_allclose(got["rbr_reparam.weight"].numpy(),
                               np.transpose(kernel, (3, 2, 0, 1)), **FOLD_TOL)
    np.testing.assert_allclose(got["rbr_reparam.bias"].numpy(), bias, **FOLD_TOL)
    if name != "in_eq_out_s2":  # where the JAX import's channel rule is the block's
        spec = jax.eval_shape(lambda: VERSIONS[version][0](cout, 3, stride, deploy=True).init(
            jax.random.PRNGKey(0), jnp.asarray(x)))
        want = state_dict_from_jax(import_checkpoint(
            native_variables_to_torch_state(variables), spec,
            training_mode="qarepvgg" if version == "v1" else "qarepvggv2", deploy=True))
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), err_msg=key,
                                       **FOLD_TOL)
    deploy = VERSIONS[version][1](cin, cout, 3, stride, deploy=True)
    deploy.load_state_dict(got, strict=True)
    tmod.eval()
    with torch.no_grad():
        out = deploy(_nchw(x))
        np.testing.assert_allclose(out.numpy(), tmod(_nchw(x)).numpy(), **TOL)
    np.testing.assert_allclose(_nhwc(out), np.asarray(jmod.apply(variables, jnp.asarray(x))),
                               **TOL)
    if cin == cout:
        with pytest.raises(ValueError, match="graph"):
            fold_to_deploy(sd)
    else:
        assert all(torch.equal(got[k], v) for k, v in fold_to_deploy(sd).items())


def _small(config_cls, name):
    """Small N-QA (V1), S-QA and M-QA (V2), see the module doc."""
    cfg = small_config(config_cls, QA_CONFIGS[name])
    if name == "n":
        cfg.model.width_multiple = 0.0625
        cfg.training_mode = "qarepvgg"
    return cfg


@functools.lru_cache(maxsize=None)
def _small_spec(name, deploy):
    """A small graph's JAX model and variables' shapes, traced once a file."""
    jmodel = jax_build_model(_small(JaxConfig, name), num_classes=NC, deploy=deploy)
    return jmodel, jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))


def _build_pair(name, deploy, seed):
    jmodel, shapes = _small_spec(name, deploy)
    variables = random_jax_variables(shapes, seed=seed)
    model = build_model(_small(Config, name), num_classes=NC, deploy=deploy, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def _images(seed):
    return np.random.default_rng(seed).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)


def _head_close(head_t, head_j):
    for key in ("cls", "reg"):
        for mt, mj in zip(head_t[key], head_j[key]):
            np.testing.assert_allclose(_nhwc(mt), np.asarray(mj), **TOL)


@pytest.mark.parametrize("name", ["n", "s", "m"])
def test_small_qa_deploy_model_and_decode_match_jax(name):
    jmodel, variables, model = _build_pair(name, True, seed=60)
    x = _images(61)
    head_j, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    preds_j = np.asarray(jmodel.apply(variables, head_j, method=jmodel.decode))
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
        preds_t = model.decode(head_t).numpy()
    _head_close(head_t, head_j)
    assert model.use_dfl == (name == "m")
    np.testing.assert_allclose(preds_t[..., :4], preds_j[..., :4], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(preds_t[..., 5:], preds_j[..., 5:], rtol=0, atol=1e-5)


@pytest.fixture(scope="module", params=["n", "s", "m"])
def small_train(request):
    jmodel, variables, model = _build_pair(request.param, False, seed=62)
    return request.param, jmodel, variables, model, _images(63)


def test_small_qa_train_model_matches_jax(small_train):
    """Train mode: every head map and every updated BN statistic (M-QA
    against the JAX forward in float64, see the module doc); then eval mode.
    Each graph's blocks are its mode's, with the identity branch where a
    stage's blocks keep their width."""
    name, jmodel, variables, model, x = small_train
    block = tcommon.QARepVGGBlock if name == "n" else tcommon.QARepVGGBlockV2
    blocks = [m for m in model.modules() if isinstance(m, tcommon.QARepVGGBlock)]
    assert blocks and all(type(m) is block for m in blocks)
    assert any(m.has_identity for m in blocks) and not all(m.has_identity for m in blocks)

    def apply_train(v, a):
        return jmodel.apply(v, a, train=True, mutable=["batch_stats"])

    run = jax_in_float64(apply_train) if name == "m" else jax.jit(apply_train)
    (head_j, _), updates = run(variables, jnp.asarray(x))
    head_e, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _head_close(head_t, head_j)
    _stats_close(model, updates["batch_stats"])
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    model.train()
    _head_close(head_t, head_e)


def test_small_qa_fold_matches_jax_fold(small_train):
    """``fold_to_deploy`` with the graph against the JAX fold, key for key,
    but for the blocks where the JAX import's channel rule is not the
    block's: small N-QA's ``ERBlock_2.0`` is 8 -> 8 channels at stride 2 (at
    width 0.0625 the stem and stage 2 both round to 8), which the JAX import
    folds with an identity its train graph does not have. The folded state
    loads into the deploy graph with strict=True, and its forward equals the
    train graph's eval forward."""
    name, _, variables, model, x = small_train
    quirk = {prefix for prefix, m in model.named_modules() if isinstance(m, tcommon.QARepVGGBlock)
             and m.rbr_dense.conv.in_channels == m.rbr_dense.conv.out_channels
             and not m.has_identity}
    assert quirk == ({"backbone.ERBlock_2.0"} if name == "n" else set())
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    deploy = build_model(_small(Config, name), num_classes=NC, deploy=True, device="cpu")
    got = fold_to_deploy(model.state_dict(), deploy)
    want = state_dict_from_jax(import_checkpoint(
        native_variables_to_torch_state(variables), _small_spec(name, True)[1],
        training_mode=_small(JaxConfig, name).training_mode, deploy=True))
    assert set(got) == set(want)
    for key in want:
        if key.rsplit(".", 2)[0] in quirk:  # the identity moves the kernel, not the bias
            if key.endswith(".weight"):
                assert not np.allclose(got[key].numpy(), want[key].numpy(), **FOLD_TOL), key
            continue
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), err_msg=key, **FOLD_TOL)
    deploy.load_state_dict(got, strict=True)
    model.eval()
    with torch.no_grad():
        want_h, _ = model(_nchw(x))
        got_h, _ = deploy(_nchw(x))
    model.train()
    _head_close(got_h, {k: [_nhwc(m) for m in v] for k, v in want_h.items()})


@pytest.mark.parametrize("name", ["n", "s", "m"])
def test_full_qa_parameter_count_matches_jax(name):
    """Both forms at full width, built and not run: the port's parameter
    counts equal the JAX package's (its variables' shapes by
    ``jax.eval_shape``), which are those of the table kept here; the train
    graph folds into the deploy graph with strict=True."""
    cfg = Config.fromfile(QA_CONFIGS[name])
    for deploy, count in zip((True, False), PARAMS[name]):
        jmodel = jax_build_model(JaxConfig.fromfile(QA_CONFIGS[name]), num_classes=80,
                                 deploy=deploy)
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
        want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
        model = build_model(cfg, num_classes=80, deploy=deploy, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == want == count
    deploy_model = build_model(cfg, num_classes=80, deploy=True, device="cpu")
    deploy_model.load_state_dict(fold_to_deploy(model.state_dict(), model), strict=True)
