"""The port's lite family (Lite_EffiBackbone + Lite_EffiNeck + DetectLite:
YOLOv6Lite-S/M/L, configs/yolov6_lite/) against the JAX package, on the CPU
in fp32, at full width (0.55-1.1 M parameters) and 80 classes.

Lite-S's graph runs at 128 px, so that stride 64 has a 2x2 grid, and the
serve and the hub at the family's 320; Lite-M and Lite-L are held by their
parameter counts and their folds. Both sides get the same seeded variables
(JAX layout, carried across by yolov6_tpu_torch/utils/weights.py), filled
by ``torch_port_utils.random_lite_variables`` so that eval-mode activations
stay O(1) through hard-swish, and the same inputs; each test first asserts
that its maps differ between its two images by at least 100 times its
tolerance, so that the comparison sees the wiring and not the biases.
Tolerances: each head map and stem, deploy and train form, within 1e-4
of its largest magnitude, and each updated BN statistic rtol 1e-4 / atol 1e-5; decoded boxes rtol 1e-4 /
atol 1e-3 px and scores atol 1e-5; the fold against the JAX fold rtol 1e-6
/ atol 1e-7 (both fold in float32 numpy); the served and the hub's
detections row for row, counts and classes equal, boxes rtol 1e-4 / atol
1e-3 px (2e-2 px of the source image for the hub's), scores atol 1e-5.
"""

import functools
import os

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

from yolov6_tpu_torch import hub
from yolov6_tpu_torch.data.image_io import imread
from yolov6_tpu_torch.layers.reparam import fold_to_deploy
from yolov6_tpu_torch.models.end2end import make_end2end_fn
from yolov6_tpu_torch.models.yolo import build_model, make_divisible_lite
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_csp_model import _nchw, _nhwc
from test_torch_inferer import _load_hubconf
from torch_port_utils import REPO_ROOT, random_lite_variables

IMG, NC, SERVE_IMG = 128, 80, 320
MAP_REL = 1e-4  # a head map's max |diff| over its max |value|
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
LITE_CONFIGS = {k: os.path.join(REPO_ROOT, "configs", "yolov6_lite", f"yolov6_lite_{k}.py")
                for k in ("s", "m", "l")}
# (deploy, train) parameter counts of the JAX package's graphs, 80 classes
PARAMS = {"s": (546_790, 557_942), "m": (778_733, 791_381), "l": (1_084_557, 1_098_789)}


@functools.lru_cache(maxsize=None)
def _jax_spec(name, deploy):
    """The JAX graph of a lite config at 80 classes and its variables'
    shapes (``jax.eval_shape``, nothing compiled), traced once a file."""
    jmodel = jax_build_model(JaxConfig.fromfile(LITE_CONFIGS[name]), num_classes=NC,
                             deploy=deploy)
    return jmodel, jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))


def _build_pair(name, deploy, seed):
    jmodel, shapes = _jax_spec(name, deploy)
    variables = random_lite_variables(shapes, seed=seed)
    model = build_model(Config.fromfile(LITE_CONFIGS[name]), num_classes=NC, deploy=deploy,
                        device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def _images(seed, n=2, img=IMG):
    return np.random.default_rng(seed).uniform(0, 1, (n, img, img, 3)).astype(np.float32)


def _maps_close(head_t, head_j, what):
    """Every head map and stem within MAP_REL of the JAX map's largest
    magnitude, and its two images' maps at least 100 times that apart."""
    for key in ("cls", "reg", "stems"):
        assert len(head_t[key]) == len(head_j[key]) == 4
        for level, (mt, mj) in enumerate(zip(head_t[key], head_j[key])):
            want = np.asarray(mj, np.float64)
            tol = MAP_REL * float(np.abs(want).max())
            assert float(np.abs(want[0] - want[1]).max()) >= 100 * tol, (what, key, level)
            err = float(np.abs(_nhwc(mt).astype(np.float64) - want).max())
            assert err <= tol, (what, key, level, err)


def test_make_divisible_lite_rounds_as_the_reference():
    """Round to the nearest multiple, at least the divisor, bumped once more
    when that loses over 10%: Lite-S's widths and the edge cases."""
    assert [make_divisible_lite(c * 0.7) for c in (24, 32, 64, 128, 256)] == [16, 32, 48, 96, 176]
    assert [make_divisible_lite(int(c * 0.5), 8) for c in (16, 32, 48, 96, 176)] == [
        8, 16, 24, 48, 88]
    assert make_divisible_lite(24) == 32 and make_divisible_lite(17.7, 8) == 16
    assert make_divisible_lite(3) == 16  # at least the divisor
    assert make_divisible_lite(23.9) == 32 and make_divisible_lite(19.5, 8) == 24  # bumped


@pytest.fixture(scope="module")
def lite_s():
    """Lite-S in both forms, each with its own variables, and two images."""
    return {"deploy": _build_pair("s", True, seed=50), "train": _build_pair("s", False, seed=52),
            "x": _images(51)}


def test_deploy_model_and_decode_match_jax(lite_s):
    """Lite-S's deploy graph: the four head maps (strides 8-64, one anchor a
    cell, no DFL), the stems the head returns, and the decode."""
    jmodel, variables, model = lite_s["deploy"]
    x = lite_s["x"]
    head_j, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    preds_j = np.asarray(jmodel.apply(variables, head_j, method=jmodel.decode))
    assert model.strides == (8, 16, 32, 64) and not model.training
    assert not model.use_dfl and model.reg_max == 0
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
        preds_t = model.decode(head_t).numpy()
    _maps_close(head_t, head_j, "deploy")
    assert [tuple(m.shape[1:]) for m in head_t["reg"]] == [(4, 16, 16), (4, 8, 8), (4, 4, 4),
                                                         (4, 2, 2)]
    assert preds_t.shape == preds_j.shape == (2, 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2, 5 + NC)
    assert np.abs(preds_j[0, :, 5:] - preds_j[1, :, 5:]).max() > 0.1
    np.testing.assert_allclose(preds_t[..., :4], preds_j[..., :4], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(preds_t[..., 4], preds_j[..., 4])
    np.testing.assert_allclose(preds_t[..., 5:], preds_j[..., 5:], rtol=0, atol=1e-5)


def test_train_model_matches_jax(lite_s):
    """Lite-S's train form in train mode: the head maps and every updated BN
    statistic (the backbone's, the neck's, DPBlock's ``bn_1``/``bn_2``);
    then in eval mode: the head maps."""
    jmodel, variables, model = lite_s["train"]
    x = lite_s["x"]
    (head_j, _), updates = jax.jit(
        lambda v, a: jmodel.apply(v, a, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    head_e, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _maps_close(head_t, head_j, "train")
    want = state_dict_from_jax({"batch_stats": updates["batch_stats"]})
    got = model.state_dict()
    assert any(".bn_2." in k for k in want) and set(want) <= set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), err_msg=key, **STATS_TOL)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    _maps_close(head_t, head_e, "train form, eval")


def test_train_state_dict_keys_match_jax_export(lite_s):
    """The train state dict has the keys of the JAX package's export, plus
    each BN's ``num_batches_tracked``: the stem, the four stages of shuffle
    blocks, the neck's CSP blocks and the stride-64 convs, the head."""
    _, variables, model = lite_s["train"]
    want = set(native_variables_to_torch_state(variables))
    got = set(model.state_dict())
    assert got - {k for k in got if k.endswith(".num_batches_tracked")} == want
    for key in ("backbone.conv_0.block.conv.weight", "backbone.lite_effiblock_1.0.conv_dw_1.",
                "backbone.lite_effiblock_3.6.se.conv2.bias", "neck.Csp_n4.blocks.conv_2.bn_2.",
                "neck.p6_conv_2.conv_pw_1.bias", "detect.stems.3.bn_1.", "detect.reg_preds.3."):
        assert any(k.startswith(key) for k in got), key


@pytest.mark.parametrize("name", ["s", "m", "l"])
def test_fold_matches_jax_fold(name):
    """``fold_to_deploy`` against the JAX fold, key for key (DPBlock's biased
    convs included); the folded state loads into the deploy graph with
    strict=True, and its forward equals the train graph's eval forward."""
    _, variables, model = _build_pair(name, False, seed=54)
    got = fold_to_deploy(model.state_dict())
    want = state_dict_from_jax(import_checkpoint(native_variables_to_torch_state(variables),
                                                 _jax_spec(name, True)[1], deploy=True))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    deploy = build_model(Config.fromfile(LITE_CONFIGS[name]), num_classes=NC, deploy=True,
                         device="cpu")
    deploy.load_state_dict(got, strict=True)
    model.eval()
    x = _images(55)
    with torch.no_grad():
        want_h, _ = model(_nchw(x))
        got_h, _ = deploy(_nchw(x))
    _maps_close(got_h, {k: [_nhwc(m) for m in v] for k, v in want_h.items()}, f"{name} fold")


def _same_detections(boxes_t, scores_t, cls_t, boxes_j, scores_j, cls_j, box_atol=1e-3):
    """Row for row: classes equal, boxes rtol 1e-4 / atol ``box_atol`` px,
    scores atol 1e-5."""
    np.testing.assert_array_equal(cls_t, cls_j)
    np.testing.assert_allclose(scores_t, scores_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(boxes_t, boxes_j, rtol=1e-4, atol=box_atol)


def test_serve_lite_s_at_320_matches_jax(lite_s):
    """uint8 BGR NHWC images at 320 through ``make_end2end_fn`` on Lite-S (80
    classes; 2,125 anchors an image over four levels, then NMS), fp32: the
    same detections as the JAX serve."""
    jmodel, variables, model = lite_s["deploy"]
    images = np.random.default_rng(57).integers(0, 256, (2, SERVE_IMG, SERVE_IMG, 3),
                                                dtype=np.uint8)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, with_preprocess=True, half=False)
    jserve = jax_make_end2end_fn(jmodel, variables, **kw)
    num_j, boxes_j, scores_j, cls_j = (np.asarray(a) for a in jserve(jnp.asarray(images)))
    num_t, boxes_t, scores_t, cls_t = (t.numpy() for t in
                                       make_end2end_fn(model, device="cpu", **kw)(images))
    with torch.no_grad():
        head, _ = model(torch.zeros(1, 3, SERVE_IMG, SERVE_IMG))
    assert sum(m.shape[2] * m.shape[3] for m in head["cls"]) == 2125
    assert num_j.min() > 10
    np.testing.assert_array_equal(num_t, num_j)
    for b in range(len(images)):
        n = num_t[b, 0]
        _same_detections(boxes_t[b, :n], scores_t[b, :n], cls_t[b, :n], boxes_j[b, :n],
                         scores_j[b, :n], cls_j[b, :n])


@pytest.mark.parametrize("name", ["s", "m", "l"])
def test_full_width_parameter_count_matches_jax(name):
    """Both forms at full width, built and not run: the port's parameter
    counts equal the JAX package's for the same config (its variables'
    shapes by ``jax.eval_shape``, nothing compiled), which are those of the
    table kept here; the train graph folds into the deploy graph with
    strict=True."""
    cfg = Config.fromfile(LITE_CONFIGS[name])
    for deploy, count in zip((True, False), PARAMS[name]):
        shapes = _jax_spec(name, deploy)[1]
        want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
        model = build_model(cfg, num_classes=NC, deploy=deploy, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == want == count
    deploy_model = build_model(cfg, num_classes=NC, deploy=True, device="cpu")
    deploy_model.load_state_dict(fold_to_deploy(model.state_dict()), strict=True)


def test_build_model_refuses_recipes_on_lite():
    """The lite family has no fuse-AB or distillation head: asking for one
    raises rather than build the plain network the JAX package builds."""
    cfg = Config.fromfile(LITE_CONFIGS["s"])
    for kw in (dict(fuse_ab=True), dict(distill_ns=True)):
        with pytest.raises(ValueError, match="lite family"):
            build_model(cfg, num_classes=NC, deploy=False, device="cpu", **kw)


def test_hub_lite_loaders_build_and_predict(lite_s, tmp_path):
    """``hub.yolov6lite_{s,m,l}`` build the deploy graphs with seeded weights
    (the same twice); Lite-S loaded from a state dict predicts at 320 on a
    demo JPEG the detections of hubconf.predict with the same weights."""
    for loader, name in ((hub.yolov6lite_s, "s"), (hub.yolov6lite_m, "m"),
                         (hub.yolov6lite_l, "l")):
        model = loader(device="cpu")
        assert type(model.detect).__name__ == "DetectLite" and not model.training
        assert sum(p.numel() for p in model.parameters()) == PARAMS[name][0]
    again = hub.yolov6lite_l(device="cpu")
    for (key, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), key
    assert len(hub.predict(model, os.path.join(REPO_ROOT, "data", "images", "image1.jpg"),
                           img_size=SERVE_IMG, conf_thres=0.001)) > 0

    hubconf = _load_hubconf()
    jmodel, variables, _ = lite_s["deploy"]
    weights = str(tmp_path / "lite_s.pt")
    torch.save(state_dict_from_jax(variables), weights)
    model = hub.yolov6lite_s(weights=weights, device="cpu")
    img = imread(os.path.join(REPO_ROOT, "data", "images", "image1.jpg"))
    dets = hub.predict(model, img, img_size=SERVE_IMG)
    dets_j = hubconf.predict(jmodel, variables, img, img_size=SERVE_IMG)
    assert dets.shape == dets_j.shape and len(dets) > 0
    _same_detections(dets[:, :4], dets[:, 4], dets[:, 5], dets_j[:, :4], dets_j[:, 4],
                     dets_j[:, 5], box_atol=2e-2)  # px of the source image
