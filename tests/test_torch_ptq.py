"""The port's quant state and PTQ (yolov6_tpu_torch/quant/state.py, ptq.py)
against the JAX package's ``QConv`` and yolov6_tpu/quant/ptq.py, on the CPU.

- The convs the port quantises, by JAX path, are the JAX ``quant``
  collection's keys: small S-opt-qat (RealVGG, deploy and train form), N
  (RepVGG's train branches), Lite-S (the SE convs, depthwise convs) and S
  with the fuse-AB train head.
- Calibrated ranges over three batches equal JAX's within relative 1e-5,
  for the deploy and the train graph (in eval mode), and JAX's ranges carry
  over by ``quant_from_jax``.
- The quantised forward and decode (JAX's calibrated ranges and quantised
  weights, fp32) match JAX's quant-mode output within the decode tests'
  tolerances (tests/test_torch_model.py: head maps rtol/atol 1e-4, boxes
  rtol 1e-4 / atol 1e-3 px, scores atol 1e-5).
- A slash-form skip pattern skips the same convs in both packages; the
  configs' dotted ``sensitive_layers_list`` skips none in either.
- Disabled, the model is bit-identical to one never quantised, with the
  same ``state_dict()`` keys and no hook left after an enabled mode.
- ``sensitivity_analyse`` ranks a toy ``eval_fn`` as JAX's does.

JAX's quant mode is global: every call that sets it runs inside the
``jax_quant`` fixture, which ends with ``set_quant_mode(False)``.
"""

import copy
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.quant import set_quant_mode
from yolov6_tpu.quant.ptq import calibrate as jax_calibrate
from yolov6_tpu.quant.ptq import quantize_variables as jax_quantize_variables
from yolov6_tpu.quant.ptq import sensitivity_analyse as jax_sensitivity_analyse
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.quant.ptq import calibrate, quantize_variables, sensitivity_analyse
from yolov6_tpu_torch.quant.state import quant_mode, quant_paths
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import quant_from_jax, state_dict_from_jax

from torch_port_utils import N_CONFIG, REPO_ROOT, S_CONFIG, random_jax_variables, small_config

S_OPT_QAT = os.path.join(REPO_ROOT, "configs", "repopt", "yolov6s_opt_qat.py")
LITE_S = os.path.join(REPO_ROOT, "configs", "yolov6_lite", "yolov6_lite_s.py")
IMG, NC = 64, 80
AMAX_REL = 1e-5
# (id, config path, cut to test size, deploy, build keywords)
GRAPHS = [
    ("s_opt_qat_deploy", S_OPT_QAT, True, True, {}),
    ("s_opt_qat_train", S_OPT_QAT, True, False, {}),
    ("n_repvgg_train", N_CONFIG, True, False, {}),
    ("lite_s_deploy", LITE_S, False, True, {}),
    ("s_fuse_ab_train", S_CONFIG, True, False, dict(fuse_ab=True)),
]


@pytest.fixture
def jax_quant():
    yield set_quant_mode
    set_quant_mode(False)


def _cfg(config_cls, path, small):
    cfg = small_config(config_cls, path) if small else config_cls.fromfile(path)
    if "training_mode" not in cfg:
        cfg.training_mode = "repvgg"
    return cfg


def _jax_model(path, small, deploy, kw):
    return jax_build_model(_cfg(JaxConfig, path, small), num_classes=NC, deploy=deploy, **kw)


def _port_model(path, small, deploy, kw, variables=None):
    model = build_model(_cfg(Config, path, small), num_classes=NC, deploy=deploy, device="cpu",
                        **kw)
    if variables is not None:
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _jax_quant_keys(jmodel, jax_quant, skip=()):
    jax_quant(True, calibrating=True, skip_patterns=list(skip))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    return {"/".join(k[:-1]) for k in flatten_dict(dict(shapes["quant"]))}


@pytest.mark.parametrize("case", GRAPHS, ids=[c[0] for c in GRAPHS])
def test_quantised_paths_equal_jax_quant_collection(case, jax_quant):
    _, path, small, deploy, kw = case
    want = _jax_quant_keys(_jax_model(path, small, deploy, kw), jax_quant)
    got = quant_paths(_port_model(path, small, deploy, kw))
    assert len(got) == len(want) > 30
    assert set(got.values()) == want


def _random_variables(jmodel, seed):
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    return random_jax_variables(shapes, seed=seed)


def _batches(seed=4, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("deploy", [True, False], ids=["deploy", "train"])
def test_calibrated_ranges_match_jax(deploy, jax_quant):
    jmodel = _jax_model(S_OPT_QAT, True, deploy, {})
    variables = _random_variables(jmodel, 21)
    batches = _batches()
    jvars = jax_calibrate(jmodel, dict(variables), batches, max_batches=2)
    want = quant_from_jax(jvars["quant"])
    model = _port_model(S_OPT_QAT, True, deploy, {}, variables).train()
    got = calibrate(model, ((b, None) for b in batches), max_batches=2)
    assert model.training  # the mode is restored
    assert set(got) == set(want) == set(quant_paths(model).values())
    for key, w in want.items():
        assert float(w) > 0
        assert abs(float(got[key]) - float(w)) <= AMAX_REL * float(w), key
    # a third batch raises no range below the two-batch ones
    more = calibrate(model, batches[2:], amax=got)
    assert all(float(more[k]) >= float(got[k]) for k in got)


def test_quantised_decode_matches_jax(jax_quant):
    jmodel = _jax_model(S_OPT_QAT, True, True, {})
    variables = _random_variables(jmodel, 3)
    batches = _batches(seed=5)
    x = batches[0].astype(np.float32) / 255.0
    float_j, _ = jmodel.apply(variables, jnp.asarray(x), train=False)
    jvars = jax_quantize_variables(jax_calibrate(jmodel, dict(variables), batches), 8)
    head_j, _ = jmodel.apply(jvars, jnp.asarray(x), train=False)  # quant mode is on
    preds_j = np.asarray(jmodel.apply(jvars, head_j, method=jmodel.decode))

    model = _port_model(S_OPT_QAT, True, True, {}, variables)
    model.load_state_dict(quantize_variables(model.state_dict(), model, 8), strict=True)
    with quant_mode(model, quant_from_jax(jvars["quant"])), torch.no_grad():
        head_t, _ = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        preds_t = model.decode(head_t).numpy()
    moved = 0.0
    for key in ("cls", "reg"):
        for mj, mt, mf in zip(head_j[key], head_t[key], float_j[key]):
            np.testing.assert_allclose(mt.permute(0, 2, 3, 1).numpy(), np.asarray(mj),
                                       rtol=1e-4, atol=1e-4)
            moved = max(moved, float(np.abs(np.asarray(mj) - np.asarray(mf)).max()))
    assert moved > 1e-3  # the quantisation moved the maps by over 10x the tolerance
    np.testing.assert_allclose(preds_t[..., :4], preds_j[..., :4], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(preds_t[..., 4], preds_j[..., 4], rtol=0, atol=1e-5)
    np.testing.assert_allclose(preds_t[..., 5:], preds_j[..., 5:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("skip", [("detect/stems", "backbone/ERBlock_3"),
                                  ("detect.stems.0.conv", "detect.cls_preds.0")],
                         ids=["slash", "dotted"])
def test_skip_patterns_select_the_same_convs(skip, jax_quant):
    jmodel = _jax_model(S_OPT_QAT, True, True, {})
    every = _jax_quant_keys(jmodel, jax_quant)
    want = _jax_quant_keys(jmodel, jax_quant, skip)
    model = _port_model(S_OPT_QAT, True, True, {})
    with quant_mode(model, calibrating=True, skip_patterns=skip) as q:
        got = set(q.paths.values())
    assert got == want
    assert (len(want) < len(every)) == (skip[0] == "detect/stems")


def test_disabled_is_bit_identical_and_leaves_no_state(jax_quant):
    jmodel = _jax_model(S_OPT_QAT, True, False, {})
    variables = _random_variables(jmodel, 8)
    model = _port_model(S_OPT_QAT, True, False, {}, variables).eval()
    plain = copy.deepcopy(model)
    keys = list(model.state_dict())
    x = torch.from_numpy(_batches(seed=9, n=1)[0]).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        want, _ = plain(x)
        amax = calibrate(model, [x.permute(0, 2, 3, 1)])
        with quant_mode(model):  # disabled: installs nothing
            assert all(not m._forward_pre_hooks for m in model.modules())
            got, _ = model(x)
        with quant_mode(model, amax):
            quantised, _ = model(x)
        after, _ = model(x)
    assert all(not m._forward_pre_hooks for m in model.modules())
    assert list(model.state_dict()) == keys
    plain.load_state_dict(model.state_dict(), strict=True)
    for key in ("cls", "reg"):
        for w, g, a, q in zip(want[key], got[key], after[key], quantised[key]):
            assert torch.equal(g, w) and torch.equal(a, w)
            assert not torch.equal(q, w)
    with pytest.raises(KeyError, match="no calibrated range"):
        quant_mode(model, {})


def test_sensitivity_analyse_ranks_as_jax():
    """A toy ``eval_fn``: the mAP drops by a fixed cost for each layer that
    is quantised (not skipped)."""
    layers = [f"backbone/ERBlock_{i}.0/conv" for i in range(2, 6)] + ["detect/cls_preds.0"]
    cost = dict(zip(layers, [0.004, 0.031, 0.0007, 0.012, 0.09]))

    def eval_fn(skip):
        return 0.5 - sum(c for p, c in cost.items() if p not in skip)

    want = jax_sensitivity_analyse(eval_fn, layers, 0.5)
    got = sensitivity_analyse(eval_fn, layers, 0.5)
    assert got == want
    assert [p for _, p in got] == sorted(layers, key=lambda p: -cost[p])
