"""The port's whole training step against the JAX package's jitted step, on
the CPU in fp32, plus the step's guards and device rule.

Both steps start from the same seeded train variables of the small S graph
(depth 0.1, width 0.125, 3 classes) and take the same images (b2@64, uint8)
and padded targets, with the S solver (GIoU, no DFL, TAL). ``batch_size=32``
is the accumulation branch the JAX bench runs; ``warmup_stepnum=0`` makes
its three steps apply, hold, apply. Per step: loss and components rtol 1e-4
/ atol 1e-6; each parameter's change within 1e-3 of the JAX change's
largest magnitude, + 1e-7; each BN running statistic and
EMA leaf within 1e-4 of the JAX leaf's largest magnitude, + 1e-6, and an EMA
parameter also within what its parameter differs by (the EMA follows its
parameter); the counters equal. Statistics are held per leaf, not per
element: fp32 sums in another order leave errors of the leaf's scale on
elements near 0.

The steps run at epoch 10 of 10, where the cosine schedule has brought the
LR to lrf·lr0 = 1e-4 (step 0 still takes the warmup bias LR, 0.1). At epoch
1 (LR 0.0098) the random model's fp32 noise grows from step to step through
the BNs of the 2x2 stage (8 samples; the JAX BN's E[x²] − E[x]² variance is
the noisier side): by the third step single leaves of the two packages
differed by up to 7.6% of their change while the losses agreed within 1e-4.
The momentum buffers, raw sums of gradients, are not compared: at the
first step the JAX step's gradients are up to 2.6e-4 of a leaf's largest
magnitude off the float64 gradient, the port's 4.5e-5, and by the third
step the buffers of BN weights whose gradient is near 0 differed by up to
0.7% of the leaf's largest value. The updates, scaled by the LR, are.
Before the three steps, one applied step at epoch 1 (weight LR 0.0098,
where the decay's share of an update is no longer below the tolerance),
from counters past the warmup: there each parameter's change and each
momentum buffer are held within 1e-3 of the JAX leaf's largest magnitude,
plus a floor of 1e-7 (times the LR for the change) for fp32 noise,
500 times below the decay's share of a weight's gradient, and, for the
change, 2 ulp of the leaf's largest parameter (the change is read off fp32
parameters; the decay moves a weight by about 80 of its ulp).
The JAX step compiles once in this file (about 80-100 s on one CPU core);
test_torch_train_step_single.py holds the single-step branch the same way.
"""

import math

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.core.train_step import create_train_state
from yolov6_tpu.core.train_step import make_train_step as jax_make_train_step
from yolov6_tpu.losses.loss import ComputeLoss as JaxComputeLoss
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.solver.build import build_param_groups
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver.build import scale_hyperparams_for_batch
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import random_jax_variables, small_s_config

IMG, NC, B, M = 64, 3, 2, 8
EPOCHS = EPOCH = 10
MID_EPOCH, MID_STEP = 1, 5  # mid-schedule: past any warmup used here
# fp32 gradient noise: a leaf whose gradient is 0 but for rounding (a bias
# ahead of a BN) reads ~5e-9; the decay adds 5e-4·|w| to a weight's gradient
MID_FLOOR = 1e-7
MID_LR = 0.01 * (1 - (1 - math.cos(math.pi * MID_EPOCH / EPOCHS)) / 2 * 0.99)  # every group's
S_SOLVER = dict(lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.0005, warmup_epochs=3.0,
                warmup_momentum=0.8, warmup_bias_lr=0.1, lr_scheduler="Cosine")
LOSS_KW = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=False, reg_max=0,
               iou_type="giou")


def _batch(seed=0, img=IMG):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, img, img, 3), dtype=np.uint8)
    targets = np.zeros((B, M, 5), np.float32)
    targets[:, :, 0] = -1
    targets[0, :3] = [[0, 0.3, 0.35, 0.4, 0.5], [2, 0.7, 0.6, 0.3, 0.35], [1, 0.5, 0.5, 0.2, 0.2]]
    targets[1, :2] = [[1, 0.4, 0.6, 0.6, 0.5], [0, 0.75, 0.25, 0.25, 0.3]]
    return images, targets


def _train_variables(seed, make_cfg=small_s_config, img=IMG):
    jmodel = jax_build_model(make_cfg(JaxConfig), num_classes=NC, deploy=False)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False))
    return jmodel, random_jax_variables(shapes, seed=seed)


def _port_step(variables, batch_size, warmup_stepnum, make_cfg=small_s_config, loss_kw=LOSS_KW,
               img=IMG):
    model = build_model(make_cfg(Config), num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    solver = scale_hyperparams_for_batch(S_SOLVER, batch_size)
    return make_train_step(model, ComputeLoss(**loss_kw), solver, 100, EPOCHS, batch_size,
                           warmup_stepnum, (img, img), half=False, device="cpu")


def _params(step):
    return {n: p.detach().clone() for n, p in step.model.named_parameters()}


def _jax_leaves(collections):
    """JAX state trees -> {port key: numpy} (num_batches_tracked dropped)."""
    return {k: v.numpy() for k, v in state_dict_from_jax(collections).items()
            if not k.endswith("num_batches_tracked")}


def _close_delta(got, want, name):
    """max |Δport − Δjax| ≤ 1e-3·max|Δjax| + 1e-7."""
    err = float(np.abs(got - want).max())
    assert err <= 1e-3 * float(np.abs(want).max()) + 1e-7, (name, err, float(np.abs(want).max()))


def _close_leaf(got, want, name, extra=0.0):
    """max |port − jax| ≤ 1e-4·max|jax| + 1e-6 (+ ``extra``), over the leaf."""
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()) + 1e-6 + extra, (name, err, extra)


def _close_rel(got, want, name, floor, rel=1e-3):
    """max |port − jax| ≤ ``rel``·max|jax| + ``floor`` over the leaf."""
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + floor, (name, err, scale)


def check_mid_schedule_step(jstep, variables, batch_size, warmup_stepnum,
                            make_cfg=small_s_config, loss_kw=LOSS_KW, rel=1e-3, port_step=None,
                            floor_scales_with_grad=False, img=IMG, use_atss=False):
    """One applied step at epoch 1 of 10, from ``step`` counters past the
    warmup and the accumulator one call short of its count, so that the
    first call applies at the full weight LR before any noise compounds.
    Each leaf is held within ``rel`` of the JAX leaf's largest magnitude,
    plus the floors. ``port_step`` builds the port's step when the plain
    ``_port_step`` does not (the training recipes). ``MID_FLOOR`` was set
    for the S step, whose largest gradient is 0.38; with
    ``floor_scales_with_grad`` the floor is at least one fp32 ulp of the
    step's largest JAX momentum (a raw gradient sum), for a loss whose
    gradients are tens of times larger. ``img`` is the images' size and
    ``use_atss`` picks the assigner of both steps. Returns the port's step
    and the JAX state after it."""
    accum_count = max(1, round(64 / batch_size)) - 1
    jstate = create_train_state(variables)._replace(
        step=jnp.asarray(MID_STEP, jnp.int32), accum_count=jnp.asarray(accum_count, jnp.int32))
    step = (port_step() if port_step is not None
            else _port_step(variables, batch_size, warmup_stepnum, make_cfg, loss_kw, img))
    step.step.fill_(MID_STEP)
    step.accum_count.fill_(accum_count)
    images, targets = _batch(img=img)
    before = _params(step)
    jstate, loss_j, comp_j = jstep(jstate, jnp.asarray(images), jnp.asarray(targets),
                                   jnp.asarray(MID_EPOCH), use_atss=use_atss)
    loss_t, comp_t = step(images, targets, MID_EPOCH, use_atss=use_atss)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(comp_t.numpy(), np.asarray(comp_j), rtol=1e-4, atol=1e-6)
    assert int(step.ema_updates) == int(jstate.ema_updates) == 1
    assert int(step.accum_count) == int(jstate.accum_count) == 0

    j_before = _jax_leaves({"params": variables["params"]})
    j_after = _jax_leaves({"params": jax.device_get(jstate.params)})
    j_momentum = _jax_leaves({"params": jax.device_get(jstate.opt.momentum_buf)})
    assert set(j_momentum) == set(step.momentum)
    floor = MID_FLOOR
    if floor_scales_with_grad:
        largest = max(float(np.abs(m).max()) for m in j_momentum.values())
        floor = max(MID_FLOOR, float(np.finfo(np.float32).eps) * largest)
    for name, p in step.model.named_parameters():
        # a change is read off fp32 parameters: each side rounds to its ulp
        ulp = float(np.spacing(np.abs(j_before[name]).max()))
        _close_rel((p.detach() - before[name]).numpy(), j_after[name] - j_before[name],
                   f"mid-schedule {name}", floor * MID_LR + 2 * ulp, rel)
        _close_rel(step.momentum[name].numpy(), j_momentum[name],
                   f"mid-schedule momentum {name}", floor, rel)
    return step, jstate


def check_ema_against_jax(step, jstate, what):
    """The port's EMA (parameters and BN statistics) against the JAX state's:
    each leaf within 1e-4 of the JAX leaf's largest magnitude, + 1e-6, and
    an EMA parameter also within what its parameter differs by (the EMA
    follows its parameter)."""
    sd = step.model.state_dict()
    j_params = _jax_leaves({"params": jax.device_get(jstate.params)})
    j_ema = _jax_leaves({"params": jax.device_get(jstate.ema_params),
                         "batch_stats": jax.device_get(jstate.ema_batch_stats)})
    ema = step.ema.state_dict()
    assert set(j_ema) == {k for k in ema if not k.endswith("num_batches_tracked")}
    for name, want in j_ema.items():
        gap = float(np.abs(sd[name].numpy() - j_params[name]).max()) if name in j_params else 0.0
        _close_leaf(ema[name].numpy(), want, f"{what} ema {name}", gap)


def check_steps_against_jax(batch_size, warmup_stepnum, seed, n_steps=3):
    """Run one mid-schedule step (``check_mid_schedule_step``), then
    ``n_steps`` of the JAX step (jitted) and the port's step side by side
    from the same variables and compare after each; returns whether each of
    the ``n_steps`` applied an update."""
    jmodel, variables = _train_variables(seed)
    solver = scale_hyperparams_for_batch(S_SOLVER, batch_size)
    jstep = jax_make_train_step(
        jmodel, JaxComputeLoss(**LOSS_KW), build_param_groups(variables["params"]), solver,
        max_stepnum=100, epochs=EPOCHS, batch_size=batch_size, warmup_stepnum=warmup_stepnum,
        img_size=(IMG, IMG))
    check_mid_schedule_step(jstep, variables, batch_size, warmup_stepnum)
    jstate = create_train_state(variables)
    step = _port_step(variables, batch_size, warmup_stepnum)
    images, targets = _batch()
    applied = []
    for i in range(n_steps):
        j_before = _jax_leaves({"params": jax.device_get(jstate.params)})
        t_before = _params(step)
        updates_before = int(jstate.ema_updates)
        jstate, loss_j, comp_j = jstep(jstate, jnp.asarray(images), jnp.asarray(targets),
                                       jnp.asarray(EPOCH), use_atss=False)
        loss_t, comp_t = step(images, targets, EPOCH)

        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(comp_t.numpy(), np.asarray(comp_j), rtol=1e-4, atol=1e-6)
        assert int(step.step) == int(jstate.step) == i + 1
        assert int(step.accum_count) == int(jstate.accum_count)
        assert int(step.ema_updates) == int(jstate.ema_updates)

        j_after = _jax_leaves({"params": jax.device_get(jstate.params)})
        for name, p in step.model.named_parameters():
            want = j_after[name] - j_before[name]
            _close_delta((p.detach() - t_before[name]).numpy(), want, f"step {i} {name}")
        sd = step.model.state_dict()
        for name, want in _jax_leaves({"batch_stats": jax.device_get(jstate.batch_stats)}).items():
            _close_leaf(sd[name].numpy(), want, f"step {i} {name}")
        # the update check above bounds what each parameter differs by
        check_ema_against_jax(step, jstate, f"step {i}")
        applied.append(int(jstate.ema_updates) > updates_before)
    return applied


def test_train_step_matches_jax_accumulate_branch():
    """Three steps of the accumulation branch (batch_size 32, the JAX
    bench's): apply, hold, apply."""
    assert check_steps_against_jax(32, warmup_stepnum=0, seed=21) == [True, False, True]


def _poison_first_conv(step):
    name, p = next((n, p) for n, p in step.model.named_parameters() if p.dim() == 4)
    with torch.no_grad():
        good = p.clone()
        p.view(-1)[0] = float("inf")
    return p, good


def _snapshot(step):
    state = {f"model.{k}": v.clone() for k, v in step.model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    state.update({f"ema.{k}": v.clone() for k, v in step.ema.state_dict().items()})
    state.update({f"momentum.{k}": v.clone() for k, v in step.momentum.items()})
    state.update({f"accum.{k}": v.clone() for k, v in step.grad_accum.items()})
    return state


@pytest.mark.parametrize("batch_size", [64, 32], ids=["single_step", "accumulate_held"])
def test_nonfinite_step_leaves_state_bit_identical(batch_size):
    """An ``inf`` in one conv weight makes the forward, the BN batch
    statistics and the gradients non-finite. Parameters, momentum, EMA, BN
    running statistics and the accumulator stay bit for bit as they were
    (on the accumulation branch the step is a held one, so only the
    accumulator could move), and a clean step afterwards is finite."""
    _, variables = _train_variables(seed=22)
    step = _port_step(variables, batch_size, warmup_stepnum=0)
    images, targets = _batch(1)
    loss0, _ = step(images, targets, EPOCH)  # populate momentum, EMA and stats
    assert torch.isfinite(loss0)
    if batch_size == 32:
        assert int(step.accum_count) == 0  # step 0 applied; step 1 holds (count 1 of 2)

    p, good = _poison_first_conv(step)
    before = _snapshot(step)
    counters = (int(step.ema_updates), int(step.accum_count))
    loss_bad, _ = step(images, targets, EPOCH)
    assert not torch.isfinite(loss_bad)
    after = _snapshot(step)
    for key, value in before.items():
        assert torch.equal(after[key], value), key
    assert int(step.ema_updates) == counters[0]
    assert int(step.accum_count) == counters[1] + (batch_size == 32)
    assert int(step.step) == 2

    with torch.no_grad():
        p.copy_(good)
    loss1, comp1 = step(images, targets, EPOCH)
    assert torch.isfinite(loss1) and torch.isfinite(comp1).all()
    assert all(torch.isfinite(v).all() for v in step.model.state_dict().values())


def test_single_step_equals_an_applied_accumulate_step():
    """On the same gradients, one call of the single-step branch (batch 64)
    and one applied call of the accumulation branch (batch 32, count 1 at
    step 0 of a warmup) give the same parameters, momentum and EMA."""
    _, variables = _train_variables(seed=23)
    images, targets = _batch(2)
    single = _port_step(variables, 64, warmup_stepnum=10)
    accum = _port_step(variables, 32, warmup_stepnum=10)
    assert single.solver_cfg == accum.solver_cfg  # the batch rescale gives the same decay
    loss_s, _ = single(images, targets, EPOCH)
    loss_a, _ = accum(images, targets, EPOCH)
    assert int(accum.accum_count) == 0 and int(accum.ema_updates) == 1
    assert torch.equal(loss_s, loss_a)
    for a, b in ((single.model, accum.model), (single.ema, accum.ema)):
        for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), name
    for name in single.momentum:
        assert torch.equal(single.momentum[name], accum.momentum[name]), name


@pytest.mark.parametrize("breach", ["zero_grad", "cast"])
def test_step_refuses_a_model_it_no_longer_owns(breach):
    """The model's tensors and gradients are views of the step's buffers:
    ``model.zero_grad()`` (gradients set to None) or a cast breaks that, and
    the next step raises instead of updating buffers the model does not
    read."""
    _, variables = _train_variables(seed=25)
    step = _port_step(variables, 32, 0)
    if breach == "zero_grad":
        step.model.zero_grad()
        match = "zero_grad"
    else:
        step.model.double()
        match = "moved or cast"
    with pytest.raises(ValueError, match=match):
        step(*_batch(), EPOCH)


def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    """No CPU fall back: without CUDA, the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = small_s_config(Config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg, num_classes=NC, deploy=False)
    model = build_model(cfg, num_classes=NC, deploy=False, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(model, ComputeLoss(**LOSS_KW), S_SOLVER, 100, EPOCHS, 32, 0, (IMG, IMG))
