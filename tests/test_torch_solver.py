"""The port's schedule, accumulation count, parameter groups, Nesterov SGD and
EMA against the JAX package, on the CPU in fp32.

Tolerances: accumulation counts and group ids exactly equal; learning rates,
momentum, the SGD update and the EMA rtol 1e-6 / atol 1e-9 (the same float32
arithmetic in the same order).
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.solver import build as jbuild
from yolov6_tpu.utils.config import Config as JaxConfig
from yolov6_tpu.utils.ema import ema_update as jax_ema_update

from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver import build as tbuild
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.ema import ema_update
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import small_m_config, small_s_config

TOL = dict(rtol=1e-6, atol=1e-9)
S_SOLVER = dict(lr0=0.01, lrf=0.01, epochs=300, warmup_bias_lr=0.1, warmup_momentum=0.8,
                momentum=0.937)


@pytest.mark.parametrize("warmup_stepnum,epoch,scheduler", [
    (10, 100, "Cosine"), (0, 0, "Cosine"), (7, 3, "Constant")])
def test_warmup_lr_momentum_matches_jax(warmup_stepnum, epoch, scheduler):
    for step in range(21):
        got = tbuild.warmup_lr_momentum(torch.tensor(step, dtype=torch.int32), epoch,
                                        warmup_stepnum, scheduler=scheduler, **S_SOLVER)
        want = jbuild.warmup_lr_momentum(jnp.int32(step), jnp.asarray(epoch), warmup_stepnum,
                                         scheduler=scheduler, **S_SOLVER)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(float(g), float(w), err_msg=f"step {step}", **TOL)


@pytest.mark.parametrize("batch_size,warmup_stepnum", [(32, 10), (16, 6), (8, 20), (64, 5),
                                                       (128, 5)])
def test_warmup_accumulate_matches_jax(batch_size, warmup_stepnum):
    """Steps 0..20. At batch 16 over 6 warmup steps the interpolation lands
    on 1.5 (step 1) and 2.5 (step 3), which round half to even, to 2."""
    got = [int(tbuild.warmup_accumulate(torch.tensor(s, dtype=torch.int32), warmup_stepnum,
                                        batch_size)) for s in range(21)]
    want = [int(jbuild.warmup_accumulate(jnp.int32(s), warmup_stepnum, batch_size))
            for s in range(21)]
    assert got == want
    if (batch_size, warmup_stepnum) == (16, 6):
        assert got[1] == 2 and got[3] == 2 and got[6] == 4 and got[20] == 4


def _jax_group_ids(make_cfg, **build_kw):
    """The JAX ``build_param_groups`` of a small train graph, as port keys."""
    jmodel = jax_build_model(make_cfg(JaxConfig), num_classes=3, deploy=False, **build_kw)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    jgroups = jbuild.build_param_groups(shapes["params"])
    # carry the group ids across as the leaves' values, at the leaves' shapes
    filled = jax.tree_util.tree_map(lambda g, leaf: np.full(leaf.shape, g, np.float32),
                                    jgroups, shapes["params"])
    return {k: int(v.flatten()[0]) for k, v in state_dict_from_jax({"params": filled}).items()
            if not k.endswith("num_batches_tracked")}


def test_param_groups_match_jax():
    """Group by module type, as upstream: BN gammas (``rbr_identity.weight``
    among them) undecayed, conv and transpose weights decayed, every bias on
    the warmup bias LR; the same split as the JAX groups by leaf name."""
    want = _jax_group_ids(small_s_config)
    model = build_model(small_s_config(Config), num_classes=3, deploy=False, device="cpu")
    got = tbuild.param_groups(model)
    assert got == want
    assert got["backbone.ERBlock_2.1.conv1.rbr_identity.weight"] == tbuild.GROUP_BN
    assert got["neck.Bifusion0.upsample.upsample_transpose.weight"] == tbuild.GROUP_WEIGHT
    assert got["detect.cls_preds.0.bias"] == tbuild.GROUP_BIAS


def test_param_groups_of_alphas_match_jax():
    """Small M: every BottleRep ``alpha`` in the bias group (no decay, the
    warmup bias LR), as the JAX step puts it; the other leaves as in S."""
    want = _jax_group_ids(small_m_config)
    model = build_model(small_m_config(Config), num_classes=3, deploy=False, device="cpu")
    got = tbuild.param_groups(model)
    assert got == want
    alphas = [k for k in got if k.endswith(".alpha")]
    assert len(alphas) == 8 and {got[k] for k in alphas} == {tbuild.GROUP_BIAS}


def _dfl_s_config(config_cls):
    cfg = small_s_config(config_cls)
    cfg.model.head.use_dfl, cfg.model.head.reg_max = True, 16
    return cfg


@pytest.mark.parametrize("recipe,make_cfg,branch", [
    ("fuse_ab", small_s_config, "cls_preds_ab"),
    ("distill_ns", _dfl_s_config, "reg_preds_dist"),
])
def test_param_groups_of_recipe_heads_match_jax(recipe, make_cfg, branch):
    """The fuse-AB and distill-NS train graphs: the train-only prediction
    convs' weights decayed, their biases on the warmup bias LR, as the JAX
    groups put them; every parameter of the graph is in the step's buffers."""
    want = _jax_group_ids(make_cfg, **{recipe: True})
    model = build_model(make_cfg(Config), num_classes=3, deploy=False, device="cpu",
                        **{recipe: True})
    got = tbuild.param_groups(model)
    assert got == want
    for i in range(3):
        assert got[f"detect.{branch}.{i}.weight"] == tbuild.GROUP_WEIGHT
        assert got[f"detect.{branch}.{i}.bias"] == tbuild.GROUP_BIAS
    step = make_train_step(model, ComputeLoss(num_classes=3, use_dfl=False, reg_max=0),
                           dict(lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=5e-4,
                                warmup_epochs=3, warmup_momentum=0.8, warmup_bias_lr=0.1),
                           10, 10, 32, 0, (64, 64), half=False, device="cpu")
    assert set(step.momentum) == set(got) == set(step.grad_accum)
    assert set(dict(step.ema.named_parameters())) == set(got)


def _seeded_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"bn": (16,), "conv": (3, 3, 4, 16), "bias": (16,), "t": (2, 2, 8, 8)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("weight_decay", [5e-4, 0.0])
def test_sgd_update_matches_jax(weight_decay):
    params, grads, bufs = _seeded_tree(0), _seeded_tree(1), _seeded_tree(2)
    group_ids = {"bn": jbuild.GROUP_BN, "conv": jbuild.GROUP_WEIGHT,
                 "bias": jbuild.GROUP_BIAS, "t": jbuild.GROUP_WEIGHT}
    lrs = (np.float32(0.004), np.float32(0.003), np.float32(0.07))
    mom = np.float32(0.91)
    new_p, new_s = jbuild.sgd_update(
        jax.tree_util.tree_map(jnp.asarray, grads), jbuild.SGDState(bufs), params, group_ids,
        *lrs, mom, weight_decay)
    names = sorted(params)
    inputs = [[torch.tensor(tree[n]) for n in names] for tree in (grads, bufs, params)]
    got_p, got_b = tbuild.sgd_update(*inputs, [group_ids[n] for n in names],
                                     *(torch.tensor(x) for x in lrs), torch.tensor(mom),
                                     weight_decay)
    for n, p, b in zip(names, got_p, got_b):
        np.testing.assert_allclose(p.numpy(), np.asarray(new_p[n]), err_msg=n, **TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(new_s.momentum_buf[n]), err_msg=n, **TOL)
    # the inputs are left as they were
    for tensors, tree in zip(inputs, (grads, bufs, params)):
        for n, t in zip(names, tensors):
            np.testing.assert_array_equal(t.numpy(), tree[n])


@pytest.mark.parametrize("updates", [1, 37, 5000])
def test_ema_update_matches_jax(updates):
    ema, model = _seeded_tree(3), _seeded_tree(4)
    want = jax_ema_update(ema, model, jnp.int32(updates))
    names = sorted(ema)
    got = ema_update([torch.from_numpy(ema[n]) for n in names],
                     [torch.from_numpy(model[n]) for n in names],
                     torch.tensor(updates, dtype=torch.int32))
    for n, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]), err_msg=n, **TOL)
    counts = ema_update([torch.zeros(3, dtype=torch.int64)], [torch.arange(3)],
                        torch.tensor(updates, dtype=torch.int32))
    assert counts[0].tolist() == [0, 1, 2]  # integer buffers are copied


@pytest.mark.parametrize("batch_size", [8, 32, 64, 256])
def test_scale_hyperparams_for_batch_matches_jax(batch_size):
    cfg = dict(lr0=0.01, weight_decay=0.0005, momentum=0.937)
    assert (tbuild.scale_hyperparams_for_batch(cfg, batch_size)
            == jbuild.scale_hyperparams_for_batch(cfg, batch_size))
