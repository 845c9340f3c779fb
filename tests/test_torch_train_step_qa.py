"""The port's training step on the S-QA graph (configs/qarepvgg/yolov6s_qa.py:
QARepVGGBlockV2 blocks, the post-sum BN, the average and identity branches)
against the JAX package's step, on the CPU: small S-QA (depth 0.1, width
0.125) at 64 px on S-QA's loss (TAL, no DFL, GIoU), one applied step at
epoch 1 of 10 (weight LR 0.0098) from counters past the warmup, by
tests/test_torch_train_step.py's ``check_mid_schedule_step``, on the
accumulation branch (``batch_size=32``).

The reference is the JAX step evaluated in float64
(``torch_port_utils.jax_in_float64``), as for M, P6 and lite; its chunked
replay compiles in a fraction of the fp32 step's whole-program compile on
one CPU core. Two checks against it:

- the port's gradients computed in float64 (its model and ComputeLoss in
  float64), plus the decay of its weight group, equal each JAX momentum
  buffer within 5e-5 of the leaf's largest magnitude + 1e-12; the bare 1x1
  kernels ``rbr_1x1.weight`` are in the decayed group and the post-sum BN's
  weight in the BN group, as the JAX groups put them;
- the port's fp32 step itself: loss and components rtol 1e-4 / atol 1e-6;
  each parameter's change and each momentum buffer within 1e-3 of the JAX
  leaf's largest magnitude plus a floor of one fp32 ulp of the step's
  largest gradient (``floor_scales_with_grad``, 4.2e-7 here). In a
  QARepVGG block the dense branch's BN sits before the post-sum BN, so the
  gradient of its shift is 0 in exact arithmetic (5.8e-16 in the float64
  step), and the port's fp32 step reads rounding of the block's summed
  gradients there: 3.3e-7 on the stem's, above the S step's 1e-7 floor and
  0.78 of this one.

A file of its own, so that the JAX work runs on its own worker.
"""

import os
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

from yolov6_tpu_torch.layers.common import QARepVGGBlockV2
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.models.effidehead import flatten_head_outputs
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver.build import (
    GROUP_BN, GROUP_WEIGHT, param_groups, scale_hyperparams_for_batch,
)
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import REPO_ROOT, jax_in_float64, small_config

S_QA = os.path.join(REPO_ROOT, "configs", "qarepvgg", "yolov6s_qa.py")
LOSS_KW = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=False, reg_max=0,
               iou_type="giou")
FLOAT64_REL, FLOAT64_FLOOR = 5e-5, 1e-12


def _make_cfg(config_cls):
    return small_config(config_cls, S_QA)


def _port_float64_momentum(variables, weight_decay):
    """The first applied step's momentum buffers, ``g + decay·w`` on the
    port's decayed group, with the port's gradients in float64."""
    model = build_model(_make_cfg(Config), num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.double().train()
    images, targets = _batch()
    head, _ = model(torch.from_numpy(images).permute(0, 3, 1, 2).double() / 255.0)
    scores, distri = flatten_head_outputs(head)
    feats_hw = [tuple(c.shape[2:4]) for c in head["cls"]]
    loss, _ = ComputeLoss(**LOSS_KW)(feats_hw, scores.double(), distri.double(),
                                     torch.from_numpy(targets), IMG, IMG, False)
    loss.backward()
    groups = param_groups(model)
    return {n: (p.grad + weight_decay * p.detach() * (groups[n] == GROUP_WEIGHT)).numpy()
            for n, p in model.named_parameters()}


def test_train_step_matches_jax_small_s_qa():
    cfg = _make_cfg(Config)
    assert cfg.training_mode == "qarepvggv2" and cfg.model.head.iou_type == LOSS_KW["iou_type"]
    jmodel, variables = _train_variables(71, _make_cfg)
    solver = scale_hyperparams_for_batch(S_SOLVER, 32)
    jstep = jax_make_train_step(
        jmodel, JaxComputeLoss(**LOSS_KW), build_param_groups(variables["params"]), solver,
        max_stepnum=100, epochs=EPOCHS, batch_size=32, warmup_stepnum=0, img_size=(IMG, IMG))
    jstep64 = jax_in_float64(partial(jstep.eager_fn, use_atss=False))
    step, jstate = check_mid_schedule_step(
        lambda *args, use_atss: jstep64(*args), variables, 32, 0, _make_cfg, LOSS_KW,
        floor_scales_with_grad=True)
    blocks = [m for m in step.model.modules() if isinstance(m, QARepVGGBlockV2)]
    assert any(m.has_avg for m in blocks) and not all(m.has_avg for m in blocks)

    raw = jax.device_get(jstate.opt.momentum_buf)
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(raw)} == {np.dtype(np.float64)}
    j_momentum = _jax_leaves({"params": raw})  # as float32: 6e-8 of each value
    port64 = _port_float64_momentum(variables, solver["weight_decay"])
    assert set(port64) == set(j_momentum)
    for key, want in j_momentum.items():
        err = float(np.abs(port64[key] - want).max())
        assert err <= FLOAT64_REL * float(np.abs(want).max()) + FLOAT64_FLOOR, (key, err)

    groups = param_groups(step.model)
    assert groups["backbone.ERBlock_2.0.rbr_1x1.weight"] == GROUP_WEIGHT
    assert groups["backbone.ERBlock_2.0.bn.weight"] == GROUP_BN
