"""The port's P6 graphs (EfficientRep6 + RepBiFPANNeck6 of N6/S6,
CSPBepBackbone_P6 + CSPRepBiFPANNeck_P6 of M6/L6, the 4-level head at
strides 8-64) against the JAX package, on the CPU in fp32.

Small N6 (RepVGG blocks, no DFL) and small L6 (``conv_silu``, BepC3 stages,
DFL) at depth 0.1 and width 0.125, 256 px, so that stride 64 has a 4x4
grid. Both sides get the same seeded variables (JAX layout, carried across
by yolov6_tpu_torch/utils/weights.py) and the same inputs. Tolerances: each
head map within 1e-4 of its largest magnitude (activations are O(1));
decoded boxes rtol 1e-4 / atol 1e-3 px (a DFL distance is a sum of 17 bins
times up to 64 px strides) and scores atol 1e-5; the fold against the JAX
fold rtol 1e-6 / atol 1e-7 (both fold in float32 numpy); the served
detections as in tests/test_torch_csp_model.py. Small L6's train-mode
forward is held against the JAX forward in float64
(``torch_port_utils.jax_in_float64``), as small M's is: the JAX fp32 BN
variance E[x²] − E[x]² cancels at that depth.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.models.end2end import make_end2end_fn as jax_make_end2end_fn
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig
from yolov6_tpu.utils.torch_import import import_checkpoint, native_variables_to_torch_state

from yolov6_tpu_torch.layers.reparam import fold_to_deploy
from yolov6_tpu_torch.models.efficientrep import CSPBepBackbone_P6, EfficientRep6
from yolov6_tpu_torch.models.end2end import make_end2end_fn
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_csp_model import _nchw, _nhwc
from torch_port_utils import P6_CONFIGS, jax_in_float64, random_jax_variables, small_config

IMG, NC = 256, 3
MAP_REL = 1e-4  # a head map's max |diff| over its max |value|
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
MODES = {"n6": "repvgg", "l6": "conv_silu"}


def _build_pair(name, deploy, seed, nc=NC):
    """Small N6 or L6 on both sides with the same seeded variables."""
    jmodel = jax_build_model(small_config(JaxConfig, P6_CONFIGS[name]), num_classes=nc,
                             deploy=deploy)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=seed)
    model = build_model(small_config(Config, P6_CONFIGS[name]), num_classes=nc, deploy=deploy,
                        device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(0, 1, (n, IMG, IMG, 3)).astype(np.float32)


def _maps_close(head_t, head_j, what):
    """Every head map within MAP_REL of the JAX map's largest magnitude."""
    for key in ("cls", "reg"):
        assert len(head_t[key]) == len(head_j[key]) == 4
        for level, (mt, mj) in enumerate(zip(head_t[key], head_j[key])):
            want = np.asarray(mj, np.float64)
            err = float(np.abs(_nhwc(mt).astype(np.float64) - want).max())
            assert err <= MAP_REL * float(np.abs(want).max()), (what, key, level, err)


@pytest.mark.parametrize("name", ["n6", "l6"])
def test_small_deploy_model_and_decode_match_jax(name):
    """Deploy graph: the four head maps (strides 8-64) and the decode."""
    jmodel, variables, model = _build_pair(name, True, seed=40)
    x = _images(41)
    head_j, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    preds_j = np.asarray(jmodel.apply(variables, head_j, method=jmodel.decode))
    assert model.strides == (8, 16, 32, 64) and not model.training
    assert model.use_dfl == (name == "l6")
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
        preds_t = model.decode(head_t).numpy()
    _maps_close(head_t, head_j, name)
    assert [tuple(m.shape[2:]) for m in head_t["cls"]] == [(32, 32), (16, 16), (8, 8), (4, 4)]
    assert preds_t.shape == preds_j.shape == (2, 32 * 32 + 16 * 16 + 8 * 8 + 4 * 4, 5 + NC)
    np.testing.assert_allclose(preds_t[..., :4], preds_j[..., :4], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(preds_t[..., 4], preds_j[..., 4])
    np.testing.assert_allclose(preds_t[..., 5:], preds_j[..., 5:], rtol=0, atol=1e-5)


@pytest.fixture(scope="module", params=["n6", "l6"])
def small_train(request):
    jmodel, variables, model = _build_pair(request.param, False, seed=42)
    return request.param, jmodel, variables, model, _images(43)


def test_small_train_model_matches_jax(small_train):
    """Train mode: the head maps and every updated BN statistic, against the
    JAX forward (small L6: in float64, see the module doc); then eval mode:
    the head maps."""
    name, jmodel, variables, model, x = small_train

    def apply_train(v, a):
        return jmodel.apply(v, a, train=True, mutable=["batch_stats"])

    run = jax_in_float64(apply_train) if name == "l6" else jax.jit(apply_train)
    (head_j, _), updates = run(variables, jnp.asarray(x))
    head_e, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _maps_close(head_t, head_j, f"{name} train")
    want = state_dict_from_jax({"batch_stats": updates["batch_stats"]})
    got = model.state_dict()
    assert want and set(want) <= set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), err_msg=key, **STATS_TOL)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    model.train()
    _maps_close(head_t, head_e, f"{name} eval")


def test_small_train_state_dict_keys_match_jax_export(small_train):
    """The train state dict has the keys of the JAX package's export, plus
    each BN's ``num_batches_tracked`` (a Transpose bias sits one level
    deeper): the sixth stage, the third BiFusion and the P6 stage names."""
    name, _, variables, model, _ = small_train
    native = native_variables_to_torch_state(variables)
    want = {k.replace(".upsample.bias", ".upsample.upsample_transpose.bias") for k in native}
    got = set(model.state_dict())
    tracked = {k for k in got if k.endswith(".num_batches_tracked")}
    assert got - tracked == want
    for key in ("neck.Bifusion2.upsample.upsample_transpose.weight",
                "neck.Rep_n6.", "neck.Rep_p5.", "backbone.ERBlock_6.2.", "detect.cls_preds.3."):
        assert any(k.startswith(key) for k in got), key
    if name == "l6":
        assert "backbone.ERBlock_6.2.sppf.cv2.block.bn.running_var" in got  # SiLU SPPF
        assert len([k for k in got if k.endswith(".alpha")]) == 11  # 5 backbone + 6 neck BepC3s
    else:
        assert "backbone.ERBlock_6.2.cspsppf.cv7.block.bn.weight" in got  # SimCSPSPPF


def test_small_fold_matches_jax_fold(small_train):
    """``fold_to_deploy`` against the JAX fold, key for key; the folded state
    loads into the deploy graph with strict=True, and its forward equals the
    train model's eval forward."""
    name, _, variables, model, x = small_train
    got = fold_to_deploy(state_dict_from_jax(variables))
    jdeploy = jax_build_model(small_config(JaxConfig, P6_CONFIGS[name]), num_classes=NC,
                              deploy=True)
    spec = jax.eval_shape(
        lambda: jdeploy.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    want = state_dict_from_jax(import_checkpoint(native_variables_to_torch_state(variables), spec,
                                                 training_mode=MODES[name], deploy=True))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    deploy = build_model(small_config(Config, P6_CONFIGS[name]), num_classes=NC, deploy=True,
                         device="cpu")
    deploy.load_state_dict(got, strict=True)
    model.eval()
    with torch.no_grad():
        want_h, _ = model(_nchw(x))
        got_h, _ = deploy(_nchw(x))
    model.train()
    _maps_close(got_h, {k: [_nhwc(m) for m in v] for k, v in want_h.items()}, f"{name} fold")


def test_serve_small_n6_matches_jax():
    """uint8 BGR NHWC images through ``make_end2end_fn`` on small N6 (decode
    over four levels, then NMS), fp32: the same detections as the JAX serve.
    Boxes within rtol 1e-4 / atol 1e-3 px, scores within 1e-5; counts and
    classes equal."""
    nc = 80
    jmodel, variables, model = _build_pair("n6", True, seed=44, nc=nc)
    images = np.random.default_rng(45).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, with_preprocess=True, half=False)
    jserve = jax_make_end2end_fn(jmodel, variables, **kw)
    want = [np.asarray(a) for a in jserve(jnp.asarray(images))]
    got = [t.numpy() for t in make_end2end_fn(model, device="cpu", **kw)(images)]
    num_j, boxes_j, scores_j, cls_j = want
    num_t, boxes_t, scores_t, cls_t = got
    assert num_j.min() > 10
    np.testing.assert_array_equal(num_t, num_j)
    np.testing.assert_array_equal(cls_t, cls_j)
    np.testing.assert_allclose(boxes_t, boxes_j, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(scores_t, scores_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,published", [("n6", 10.4e6), ("s6", 41.4e6), ("m6", 79.6e6),
                                            ("l6", 140.4e6)])
def test_full_width_parameter_count_matches_jax(name, published):
    """Full-width P6 deploy graphs, built and not run: the port's parameter
    count equals the JAX package's for the same config (its variables'
    shapes by ``jax.eval_shape``, nothing compiled), within 0.05 M of the
    published count; the train graph folds into the deploy graph with
    strict=True."""
    jmodel = jax_build_model(JaxConfig.fromfile(P6_CONFIGS[name]), num_classes=80, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    cfg = Config.fromfile(P6_CONFIGS[name])
    deploy = build_model(cfg, num_classes=80, deploy=True, device="cpu")
    got = sum(p.numel() for p in deploy.parameters())
    assert got == want
    assert abs(got - published) <= 0.05e6
    train = build_model(cfg, num_classes=80, deploy=False, device="cpu")
    deploy.load_state_dict(fold_to_deploy(train.state_dict()), strict=True)


@pytest.mark.parametrize("fuse_P2", [True, False])
def test_p6_backbones_levels(fuse_P2):
    """CSPBepBackbone_P6 emits all five levels, P2 included, whatever
    ``fuse_P2`` says (the JAX package's and upstream's quirk);
    EfficientRep6 emits P2 only with ``fuse_P2``."""
    ch, nr = [8, 8, 16, 16, 24, 24], [1, 1, 1, 1, 1, 1]
    x = torch.zeros(1, 3, 128, 128)
    csp = CSPBepBackbone_P6(ch, nr, fuse_P2=fuse_P2, deploy=True)
    rep = EfficientRep6(ch, nr, fuse_P2=fuse_P2, deploy=True)
    with torch.no_grad():
        csp_hw = [tuple(o.shape[2:]) for o in csp(x)]
        rep_hw = [tuple(o.shape[2:]) for o in rep(x)]
    five = [(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)]
    assert csp_hw == five
    assert rep_hw == (five if fuse_P2 else five[1:])


def test_build_model_refuses_recipe_heads_a_p6_config_lacks():
    """What the JAX package cannot build raises and names itself: the
    distill-NS head on a 4-level head, and the fuse-AB head on a config
    without ``head.anchors_init`` (every P6 config)."""
    cfg = Config.fromfile(P6_CONFIGS["n6"])
    with pytest.raises(ValueError, match="3-layer"):
        build_model(cfg, num_classes=80, deploy=False, device="cpu", distill_ns=True)
    with pytest.raises(ValueError, match="anchors_init.*YOLOv6n6"):
        build_model(cfg, num_classes=80, deploy=False, device="cpu", fuse_ab=True)
