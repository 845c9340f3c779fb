"""The port's training step on the M graph against the JAX package's step,
on the CPU: small M (depth 0.1, width 0.125: BepC3 stages of BottleReps
with their alphas, the CSP neck, the DFL head), ``ComputeLoss`` with DFL
(reg_max 16) and GIoU on the TAL branch, as M trains; the accumulation
branch (``batch_size=32``).

The reference is the JAX package's own step evaluated in float64
(``torch_port_utils.jax_in_float64``: its jaxpr replayed with every float32
value raised to float64), one applied step at epoch 1 of 10 (weight LR
0.0098) from counters past the warmup. The JAX step in float32 is no
reference at M's depth: its BN variance E[x²] − E[x]² cancels on channels
of large mean and small spread, and its momentum buffers came out up to
11% of a leaf's largest magnitude off the float64 step (median 1.1%).

Two checks against that float64 step:

- the port's gradients, computed in float64 (its model in float64; its
  ComputeLoss works in fp32, as it does in training), plus the decay of
  its weight group, equal each JAX momentum buffer within 1e-5 of the
  leaf's largest magnitude + 1e-12. The two float64 computations agreed
  within 3e-6 of a leaf's scale, so a wrong gradient, loss weight or
  decay group fails here;
- the port's fp32 step itself (``check_mid_schedule_step``): loss and
  components rtol 1e-4 / atol 1e-6; each parameter's change, the alphas'
  among them, and each momentum buffer within 1e-2 of the JAX leaf's
  largest magnitude plus the S step's floors. Not the S step's 1e-3: the
  port's fp32 rounding at M's depth reached 4.4e-3 of a leaf's scale on a
  BottleRep alpha (a scalar whose gradient is a sum over a whole feature
  map, with cancellation) and 9e-4 on tensor leaves.

A file of its own, so that the JAX compile (about 3 minutes on one CPU
core, cold) runs on its own worker.
"""

from functools import partial

import numpy as np
import torch

import jax

from test_torch_train_step import (
    EPOCHS, IMG, NC, S_SOLVER, _batch, _jax_leaves, _train_variables, check_mid_schedule_step,
)

from yolov6_tpu.core.train_step import make_train_step as jax_make_train_step
from yolov6_tpu.losses.loss import ComputeLoss as JaxComputeLoss
from yolov6_tpu.solver.build import build_param_groups

from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.models.effidehead import flatten_head_outputs
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver.build import (
    GROUP_BIAS, GROUP_WEIGHT, param_groups, scale_hyperparams_for_batch,
)
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import jax_in_float64, small_m_config

M_LOSS_KW = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=True, reg_max=16,
                 iou_type="giou")
FP32_STEP_REL = 1e-2  # the port's fp32 step against the float64 one (module doc)
FLOAT64_REL, FLOAT64_FLOOR = 1e-5, 1e-12


def _port_float64_momentum(variables, weight_decay):
    """The first applied step's momentum buffers, ``g + decay·w`` on the
    port's decayed group, with the port's gradients in float64."""
    model = build_model(small_m_config(Config), num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.double().train()
    images, targets = _batch()
    x = torch.from_numpy(images).permute(0, 3, 1, 2).double() / 255.0
    head, _ = model(x)
    scores, distri = flatten_head_outputs(head)
    feats_hw = [tuple(c.shape[2:4]) for c in head["cls"]]
    loss, _ = ComputeLoss(**M_LOSS_KW)(feats_hw, scores, distri, torch.from_numpy(targets),
                                       IMG, IMG, False)
    loss.backward()
    groups = param_groups(model)
    return {n: (p.grad + weight_decay * p.detach() * (groups[n] == GROUP_WEIGHT)).numpy()
            for n, p in model.named_parameters()}


def test_train_step_matches_jax_small_m_dfl():
    jmodel, variables = _train_variables(seed=27, make_cfg=small_m_config)
    batch_size = 32
    solver = scale_hyperparams_for_batch(S_SOLVER, batch_size)
    jstep = jax_make_train_step(
        jmodel, JaxComputeLoss(**M_LOSS_KW), build_param_groups(variables["params"]), solver,
        max_stepnum=100, epochs=EPOCHS, batch_size=batch_size, warmup_stepnum=0,
        img_size=(IMG, IMG))
    jstep64 = jax_in_float64(partial(jstep.eager_fn, use_atss=False))
    step, jstate = check_mid_schedule_step(
        lambda *args, use_atss: jstep64(*args), variables, batch_size, 0, small_m_config,
        M_LOSS_KW, rel=FP32_STEP_REL)

    raw = jax.device_get(jstate.opt.momentum_buf)
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(raw)} == {np.dtype(np.float64)}
    j_momentum = _jax_leaves({"params": raw})  # as float32: 6e-8 of each value
    port64 = _port_float64_momentum(variables, solver["weight_decay"])
    assert set(port64) == set(j_momentum)
    for name, want in j_momentum.items():
        err = float(np.abs(port64[name] - want).max())
        assert err <= FLOAT64_REL * float(np.abs(want).max()) + FLOAT64_FLOOR, (name, err)

    alphas = [n for n in step.param_names if n.endswith(".alpha")]
    assert len(alphas) == 8
    groups = param_groups(step.model)
    assert all(groups[n] == GROUP_BIAS for n in alphas)
    assert all(float(step.momentum[n].abs().max()) > 0 for n in alphas)
