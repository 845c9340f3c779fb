"""The training recipes' heads and anchors against the JAX package, on the CPU
in fp32: the anchor-based anchors, the fuse-AB head (``DetectFuseAB``,
``flatten_ab_outputs``) and the distill-NS head (``DetectDistillNS``), their
train graphs carried by ``state_dict_from_jax`` and their folds.

Small S (depth 0.1, width 0.125, 4 classes) at 64 px: fuse-AB on the S
config as shipped (no DFL), distill-NS on the S config with DFL switched on
(``use_dfl=True``, ``reg_max=16``), as the recipe trains it. Tolerances: the
anchors exactly equal; each train-graph head map in eval mode within 1e-5
of the JAX map's largest magnitude; ``flatten_ab_outputs`` on the same maps
within 1e-6 (rtol and atol); each folded deploy map within 1e-4 of the JAX
deploy forward's largest magnitude.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.assigners.anchor_generator import generate_anchors as jax_generate_anchors
from yolov6_tpu.models.heads.effidehead_fuseab import flatten_ab_outputs as jax_flatten_ab
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig
from yolov6_tpu.utils.torch_import import import_checkpoint, native_variables_to_torch_state

from yolov6_tpu_torch.assigners.anchor_generator import generate_anchors
from yolov6_tpu_torch.layers.reparam import TRAIN_ONLY_BRANCHES, fold_to_deploy
from yolov6_tpu_torch.models.heads.effidehead_fuseab import flatten_ab_outputs
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import random_jax_variables, small_s_config

IMG, NC = 64, 4
STRIDES = (8, 16, 32)
RECIPES = {
    "fuse_ab": dict(kw=dict(fuse_ab=True), dfl=False, maps=("cls", "reg", "cls_ab", "reg_ab")),
    "distill_ns": dict(kw=dict(distill_ns=True), dfl=True, maps=("cls", "reg", "reg_dist")),
}


def _config(config_cls, dfl: bool):
    cfg = small_s_config(config_cls)
    if dfl:
        cfg.model.head.use_dfl, cfg.model.head.reg_max = True, 16
    return cfg


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close_to_scale(got, want, rel, what):
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


@pytest.mark.parametrize("hw", [(64, 64), (640, 640), (96, 160)])
def test_ab_anchors_match_jax(hw):
    """Three anchors a cell, each level's grid tiled anchor-major."""
    feats = [(hw[0] // s, hw[1] // s) for s in STRIDES]
    want = jax_generate_anchors(feats, STRIDES, 5.0, 0.5, is_eval=False, mode="ab")
    got = generate_anchors(feats, STRIDES, 5.0, 0.5, mode="ab", device="cpu")
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2] == want[2] == [h * w * 3 for h, w in feats]
    # the second anchor of a level starts the grid again
    n0 = feats[0][0] * feats[0][1]
    assert torch.equal(got[1][:n0], got[1][n0:2 * n0])


@pytest.fixture(scope="module", params=sorted(RECIPES))
def recipe(request):
    """A recipe's small S train graph on both sides with the same seeded
    variables (carried with ``strict=True``), and a batch of inputs."""
    name = request.param
    r = RECIPES[name]
    jmodel = jax_build_model(_config(JaxConfig, r["dfl"]), num_classes=NC, deploy=False,
                             **r["kw"])
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=31)
    model = build_model(_config(Config, r["dfl"]), num_classes=NC, deploy=False, device="cpu",
                        **r["kw"])
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    x = np.random.default_rng(32).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    return name, jmodel, variables, model, x


def test_train_graph_head_maps_match_jax(recipe):
    """Eval mode: every head map of the train graph, the train-only
    branches included."""
    name, jmodel, variables, model, x = recipe
    want, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got, _ = model(_nchw(x))
    assert set(got) == set(RECIPES[name]["maps"]) and set(want) >= set(got)
    for key in got:
        assert len(got[key]) == len(want[key]) == 3
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            _close_to_scale(_nhwc(g), np.asarray(w), 1e-5, f"{name} {key}.{i}")


def test_flatten_ab_outputs_matches_jax():
    """The anchor-based branch flattened and decoded from the same maps: the
    class scores and the xywh boxes, anchor-major."""
    rng = np.random.default_rng(33)
    maps = {"cls_ab": [rng.normal(-2, 2, (2, IMG // s, IMG // s, NC * 3)) for s in STRIDES],
            "reg_ab": [rng.normal(0, 1.5, (2, IMG // s, IMG // s, 12)) for s in STRIDES]}
    maps = {k: [m.astype(np.float32) for m in v] for k, v in maps.items()}
    anchors_init = tuple(map(tuple, small_s_config(Config).model.head.anchors_init))
    want = jax_flatten_ab({k: [jnp.asarray(m) for m in v] for k, v in maps.items()},
                          anchors_init, STRIDES)
    got = flatten_ab_outputs({k: [_nchw(m) for m in v] for k, v in maps.items()},
                             anchors_init, STRIDES)
    assert got[0].shape == (2, 84 * 3, NC) and got[1].shape == (2, 84 * 3, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_fold_drops_the_train_only_branches(recipe):
    """The fold of a recipe's train graph loads with ``strict=True`` into the
    deploy graph of the config users serve (for distill-NS the config
    without DFL), has exactly its keys, and its forward equals the JAX
    deploy forward of the JAX fold of the same variables."""
    name, jmodel, variables, model, x = recipe
    r = RECIPES[name]
    folded = fold_to_deploy(model.state_dict())
    assert not any(k.startswith(TRAIN_ONLY_BRANCHES) for k in folded)
    deploy = build_model(small_s_config(Config), num_classes=NC, deploy=True, device="cpu")
    deploy.load_state_dict(folded, strict=True)
    # the recipe's own deploy graph is that same graph
    recipe_deploy = build_model(_config(Config, r["dfl"]), NC, deploy=True, device="cpu",
                                **r["kw"])
    assert {k: v.shape for k, v in recipe_deploy.state_dict().items()} == \
        {k: v.shape for k, v in deploy.state_dict().items()}

    jdeploy = jax_build_model(_config(JaxConfig, r["dfl"]), num_classes=NC, deploy=True,
                              **r["kw"])
    spec = jax.eval_shape(
        lambda: jdeploy.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    jfolded = import_checkpoint(native_variables_to_torch_state(variables), spec, deploy=True)
    want, _ = jax.jit(lambda v, a: jdeploy.apply(v, a, train=False))(jfolded, jnp.asarray(x))
    with torch.no_grad():
        got, _ = deploy(_nchw(x))
    assert set(got) == {"cls", "reg"}
    for key in got:
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            _close_to_scale(_nhwc(g), np.asarray(w), 1e-4, f"{name} folded {key}.{i}")


def test_recipe_models_decode_the_shipped_branch(recipe):
    """The distill-NS model decodes plain ltrb boxes (no DFL) while its
    config says DFL; the fuse-AB model decodes as its config says. The
    decode reads only the shipped maps, so a train graph in eval mode and its
    fold decode alike."""
    name, _, _, model, x = recipe
    # S ships without DFL; the distill-NS model so even with its DFL config
    assert (model.use_dfl, model.reg_max) == (False, 0)
    if name == "distill_ns":
        assert model.detect.reg_max == 16
    deploy = build_model(small_s_config(Config), num_classes=NC, deploy=True, device="cpu")
    deploy.load_state_dict(fold_to_deploy(model.state_dict()), strict=True)
    with torch.no_grad():
        want = model.decode(model(_nchw(x))[0])
        got = deploy.decode(deploy(_nchw(x))[0])
    assert got.shape == (2, 84, 5 + NC)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
