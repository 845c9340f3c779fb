"""The port's M/L graph (SPPF/SimSPPF, BottleRep, RepBlock of BottleReps,
BepC3, CSPBepBackbone, CSPRepBiFPANNeck, the DFL head) against the JAX
package, in both forms and both block modes, on the CPU in fp32.

Both sides get the same seeded variables (JAX layout, carried across by
yolov6_tpu_torch/utils/weights.py, BottleRep alphas in [0.5, 1.5]) and the
same inputs. Tolerances, those of the S tests: blocks and head maps, train-
and eval-mode, and the updated BN statistics rtol 1e-4 / atol 1e-5
(activations are O(1)); decoded boxes rtol 1e-4 / atol 1e-3 px and scores
atol 1e-5 (a DFL distance is a sum of 17 bins times up to 16 px strides);
the fold against the JAX fold rtol 1e-6 / atol 1e-7 (both fold in float32
numpy); the served detections as in tests/test_torch_end2end.py.

One exception, the small models' train-mode forward: the JAX package's
fp32 error at M's depth exceeds the S tolerance (its BN's E[x²] − E[x]²
variance over 8 samples in the 2x2 stage). So the port's train-mode head
maps and updated BN statistics are held within the S tolerance of the JAX
forward evaluated in float64 (``torch_port_utils.jax_in_float64``: the
package's own jaxpr replayed in float64), and the JAX fp32 forward is held
within rtol 1e-3 / atol 1e-4 of that same float64 forward.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.layers import common as jcommon
from yolov6_tpu.models.end2end import make_end2end_fn as jax_make_end2end_fn
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig
from yolov6_tpu.utils.torch_import import import_checkpoint, native_variables_to_torch_state

from yolov6_tpu_torch.layers import common as tcommon
from yolov6_tpu_torch.layers.reparam import fold_to_deploy
from yolov6_tpu_torch.models.end2end import make_end2end_fn
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import (
    L_CONFIG, M_CONFIG, REPO_ROOT, jax_in_float64, random_jax_variables, small_l_config,
    small_m_config,
)

TOL = dict(rtol=1e-4, atol=1e-5)
JAX_TRAIN_TOL = dict(rtol=1e-3, atol=1e-4)  # the JAX fp32 train forward (module doc)
IMG, NC = 64, 3
SMALL = {"m": small_m_config, "l": small_l_config}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _stats_close(port_module, jax_stats, **tol):
    """Every running_mean/running_var of the port module equals the JAX
    batch_stats leaf it came from."""
    want = state_dict_from_jax({"batch_stats": jax_stats})
    got = port_module.state_dict()
    assert want and set(want) <= set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), err_msg=key, **(tol or TOL))


J_REP, J_RELU, J_SILU = jcommon.RepVGGBlock, jcommon.ConvBNReLU, jcommon.ConvBNSiLU
T_REP, T_RELU, T_SILU = tcommon.RepVGGBlock, tcommon.ConvBNReLU, tcommon.ConvBNSiLU

# (id, JAX module(deploy), port module(deploy), input shape NHWC). BepC3's
# out=48 at e=2/3 has the hidden width int(31.999...) = 31, as M's widths do.
BLOCK_CASES = [
    ("SimSPPF", lambda d: jcommon.SimSPPF(16, 5, deploy=d),
     lambda d: tcommon.SimSPPF(8, 16, deploy=d), (2, 9, 9, 8)),
    ("SPPF", lambda d: jcommon.SPPF(16, 5, deploy=d),
     lambda d: tcommon.SPPF(8, 16, deploy=d), (2, 9, 9, 8)),
    ("BottleRep_repvgg_alpha", lambda d: jcommon.BottleRep(8, J_REP, True, deploy=d),
     lambda d: tcommon.BottleRep(8, 8, T_REP, True, deploy=d), (2, 10, 10, 8)),
    ("BottleRep_conv_silu_no_residual", lambda d: jcommon.BottleRep(12, J_SILU, True, deploy=d),
     lambda d: tcommon.BottleRep(8, 12, T_SILU, True, deploy=d), (2, 10, 10, 8)),
    ("RepBlock_BottleRep_n7_repvgg",
     lambda d: jcommon.RepBlock(8, 7, jcommon.BottleRep, J_REP, deploy=d),
     lambda d: tcommon.RepBlock(8, 8, 7, tcommon.BottleRep, T_REP, deploy=d), (2, 8, 8, 8)),
    ("RepBlock_BottleRep_n4_conv_silu",
     lambda d: jcommon.RepBlock(8, 4, jcommon.BottleRep, J_SILU, deploy=d),
     lambda d: tcommon.RepBlock(6, 8, 4, tcommon.BottleRep, T_SILU, deploy=d), (2, 8, 8, 6)),
    ("BepC3_e2/3_repvgg", lambda d: jcommon.BepC3(48, 4, float(2) / 3, J_REP, deploy=d),
     lambda d: tcommon.BepC3(16, 48, 4, float(2) / 3, T_REP, deploy=d), (2, 8, 8, 16)),
    ("BepC3_e1/2_conv_silu", lambda d: jcommon.BepC3(16, 3, 0.5, J_SILU, deploy=d),
     lambda d: tcommon.BepC3(24, 16, 3, 0.5, T_SILU, deploy=d), (2, 8, 8, 24)),
    ("BepC3_e1/2_conv_relu", lambda d: jcommon.BepC3(16, 2, 0.5, J_RELU, deploy=d),
     lambda d: tcommon.BepC3(8, 16, 2, 0.5, T_RELU, deploy=d), (2, 8, 8, 8)),
]


@pytest.mark.parametrize("form", ["deploy", "train"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_csp_block_matches_jax(case, form):
    """Deploy form: the output. Train form: train mode (outputs and updated
    BN statistics), then eval mode."""
    check_block_matches_jax(case, form == "deploy")


def check_block_matches_jax(case, deploy):
    """A block case ``(id, JAX module(deploy), port module(deploy), input
    shape NHWC)`` in one form, as ``test_csp_block_matches_jax`` holds it."""
    _, make_jax, make_port, in_shape = case
    x = np.random.default_rng(31).standard_normal(in_shape).astype(np.float32)
    jmod = make_jax(deploy)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = random_jax_variables(shapes, seed=32)
    port = make_port(deploy)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    if not deploy:
        want, updates = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        port.train()
        with torch.no_grad():
            got = _nhwc(port(_nchw(x)))
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        _stats_close(port, updates["batch_stats"])
        port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.eval()
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)


def _build_pair(size, deploy, seed, img=IMG, nc=NC):
    """The small M or L graph on both sides with the same seeded variables."""
    jmodel = jax_build_model(SMALL[size](JaxConfig), num_classes=nc, deploy=deploy)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False))
    variables = random_jax_variables(shapes, seed=seed)
    model = build_model(SMALL[size](Config), num_classes=nc, deploy=deploy, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


@pytest.fixture(scope="module", params=["m", "l"])
def small_train(request):
    jmodel, variables, model = _build_pair(request.param, False, seed=33)
    x = np.random.default_rng(34).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    return request.param, jmodel, variables, model, x


def _head_close(head_t, head_j, **tol):
    for key in ("cls", "reg"):
        for mt, mj in zip(head_t[key], head_j[key]):
            np.testing.assert_allclose(_nhwc(mt), np.asarray(mj), **(tol or TOL))


@pytest.mark.parametrize("size", ["m", "l"])
def test_small_deploy_model_and_dfl_decode_match_jax(size):
    """Deploy graph: every head map and the DFL decode."""
    jmodel, variables, model = _build_pair(size, True, seed=35)
    x = np.random.default_rng(36).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    head_j, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    preds_j = np.asarray(jmodel.apply(variables, head_j, method=jmodel.decode))
    assert model.use_dfl and model.reg_max == 16 and not model.training
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
        preds_t = model.decode(head_t).numpy()
    _head_close(head_t, head_j)
    assert head_t["reg"][0].shape[1] == 4 * 17
    assert preds_t.shape == preds_j.shape == (2, 8 * 8 + 4 * 4 + 2 * 2, 5 + NC)
    np.testing.assert_allclose(preds_t[..., :4], preds_j[..., :4], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(preds_t[..., 4], preds_j[..., 4])
    np.testing.assert_allclose(preds_t[..., 5:], preds_j[..., 5:], rtol=0, atol=1e-5)


def test_small_train_model_matches_jax(small_train):
    """Train mode: every head map and every updated BN statistic against
    the JAX forward in float64, and the JAX fp32 forward against it too
    (see the module doc); then eval mode: every head map."""
    _, jmodel, variables, model, x = small_train

    def apply_train(v, a):
        return jmodel.apply(v, a, train=True, mutable=["batch_stats"])

    (head_j, _), updates = jax.jit(apply_train)(variables, jnp.asarray(x))
    (head_64, _), updates_64 = jax_in_float64(apply_train)(variables, jnp.asarray(x))
    assert head_64["cls"][0].dtype == jnp.float64
    head_e, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _head_close(head_t, head_64)
    _stats_close(model, updates_64["batch_stats"])
    for key in ("cls", "reg"):
        for mj, m64 in zip(head_j[key], head_64[key]):
            np.testing.assert_allclose(np.asarray(mj), np.asarray(m64), **JAX_TRAIN_TOL)
    for want, got in zip(jax.tree_util.tree_leaves(updates_64), jax.tree_util.tree_leaves(updates)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **JAX_TRAIN_TOL)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _head_close(head_t, head_e)
    model.train()


def test_small_train_state_dict_keys_match_jax_export(small_train):
    """The train state dict has the keys of the JAX package's
    ``native_variables_to_torch_state``, alphas included, plus each BN's
    ``num_batches_tracked`` (a Transpose bias sits one level deeper, as in
    the S test)."""
    size, _, variables, model, _ = small_train
    native = native_variables_to_torch_state(variables)
    want = {k.replace(".upsample.bias", ".upsample.upsample_transpose.bias") for k in native}
    got = set(model.state_dict())
    tracked = {k for k in got if k.endswith(".num_batches_tracked")}
    assert got - tracked == want
    alphas = sorted(k for k in got if k.endswith(".alpha"))
    # one BottleRep in each of the 4 backbone and 4 neck BepC3s at depth 0.1
    assert len(alphas) == 8 and "backbone.ERBlock_2.1.m.conv1.alpha" in alphas
    if size == "l":
        assert "backbone.stem.block.bn.weight" in got
        assert "backbone.ERBlock_5.2.sppf.cv2.block.bn.running_var" in got
    else:
        assert "backbone.stem.rbr_1x1.conv.weight" in got
        assert "neck.Rep_n4.m.conv1.conv2.rbr_identity.weight" in got


def test_small_fold_matches_jax_fold(small_train):
    """``fold_to_deploy`` against the JAX fold, key for key; the folded state
    loads into the deploy graph with strict=True, alphas carried as they
    are, and its forward equals the train model's eval forward."""
    size, _, variables, model, x = small_train
    got = fold_to_deploy(state_dict_from_jax(variables))
    jdeploy = jax_build_model(SMALL[size](JaxConfig), num_classes=NC, deploy=True)
    spec = jax.eval_shape(
        lambda: jdeploy.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    mode = "conv_silu" if size == "l" else "repvgg"
    want = state_dict_from_jax(import_checkpoint(native_variables_to_torch_state(variables), spec,
                                                 training_mode=mode, deploy=True))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    src = state_dict_from_jax(variables)
    for key in [k for k in want if k.endswith(".alpha")]:
        assert torch.equal(got[key], src[key])

    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    deploy = build_model(SMALL[size](Config), num_classes=NC, deploy=True, device="cpu")
    deploy.load_state_dict(got, strict=True)
    model.eval()
    with torch.no_grad():
        want_h, _ = model(_nchw(x))
        got_h, _ = deploy(_nchw(x))
    model.train()
    for key in ("cls", "reg"):
        for mg, mw in zip(got_h[key], want_h[key]):
            np.testing.assert_allclose(mg.numpy(), mw.numpy(), **TOL)


def test_serve_small_m_matches_jax():
    """uint8 BGR NHWC images through ``make_end2end_fn`` on small M (DFL
    decode, then NMS), fp32: the same detections as the JAX serve. Boxes
    within rtol 1e-4 / atol 1e-3 px, scores within 1e-5; counts and classes
    equal."""
    img, nc = 128, 80
    jmodel, variables, model = _build_pair("m", True, seed=37, img=img, nc=nc)
    images = np.random.default_rng(38).integers(0, 256, (2, img, img, 3), dtype=np.uint8)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, with_preprocess=True, half=False)
    want = [np.asarray(a) for a in jax_make_end2end_fn(jmodel, variables, **kw)(jnp.asarray(images))]
    got = [t.numpy() for t in make_end2end_fn(model, device="cpu", **kw)(images)]
    num_j, boxes_j, scores_j, cls_j = want
    num_t, boxes_t, scores_t, cls_t = got
    assert num_j.min() > 10
    np.testing.assert_array_equal(num_t, num_j)
    np.testing.assert_array_equal(cls_t, cls_j)
    np.testing.assert_allclose(boxes_t, boxes_j, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(scores_t, scores_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("path,published", [(M_CONFIG, 34.9e6), (L_CONFIG, 59.6e6)],
                         ids=["m", "l"])
def test_full_width_parameter_count_matches_jax(path, published):
    """Full-width M and L deploy graphs, built and not run: the port's
    parameter count equals the JAX package's for the same config (its
    variables' shapes by ``jax.eval_shape``, nothing compiled), within 0.2%
    of the published count; the train graph folds into the deploy graph
    with strict=True."""
    jmodel = jax_build_model(JaxConfig.fromfile(path), num_classes=80, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    cfg = Config.fromfile(path)
    deploy = build_model(cfg, num_classes=80, deploy=True, device="cpu")
    got = sum(p.numel() for p in deploy.parameters())
    assert got == want
    assert abs(got - published) < 0.002 * published
    train = build_model(cfg, num_classes=80, deploy=False, device="cpu")
    deploy.load_state_dict(fold_to_deploy(train.state_dict()), strict=True)


@pytest.mark.parametrize("path,match", [
    ("configs/repopt/yolov6s_opt.py", "'repopt' is RepOpt's"),
    ("configs/repopt/yolov6s_hs.py", "'hyper_search' is RepOpt's"),
])
def test_build_model_refuses_unported_configs(path, match):
    """What is still unported raises and names itself; nothing stands in:
    RepOpt's block modes (RealVGG, LinearAdd and ScaleLayer blocks)."""
    cfg = Config.fromfile(f"{REPO_ROOT}/{path}")
    with pytest.raises(NotImplementedError, match=match):
        build_model(cfg, num_classes=80, deploy=False, device="cpu")
