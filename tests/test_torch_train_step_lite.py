"""The port's training step on YOLOv6Lite-S against the JAX package's step,
on the CPU: one applied step at epoch 1 of 10 (weight LR 0.0098) from
counters past the warmup, by tests/test_torch_train_step.py's
``check_mid_schedule_step``, on the accumulation branch
(``batch_size=32``), with Lite-S's loss (configs/yolov6_lite/yolov6_lite_s.py):
no DFL, SIoU, the four strides 8-64, one anchor a cell, on the TAL branch
and on the ATSS branch, which lite trains its first 4 epochs on
(``atss_warmup_epoch``). Lite-S at full width (0.56 M parameters in its
train form) at 128 px, so that stride 64 has a 2x2 grid.

The reference is the JAX step evaluated in float64
(``torch_port_utils.jax_in_float64``), as for M and P6: the lite graph
puts a BN right after another (the shuffle blocks' depthwise ConvBN feeds a
ConvBN with hard-swish), so the first BN's shift gets a gradient that is 0
but for rounding, and there the two packages' fp32 momentum buffers
differed by 1.04e-7 and 1.07e-7, above the 1e-7 floor. The float64 replay
also compiles in about 30 s where XLA took about 230 s for the fp32 step
whole, on one CPU core. Two checks against that float64 step:

- the port's gradients computed in float64 (its model and ComputeLoss in
  float64), plus the decay of its weight group, equal each JAX momentum
  buffer within 5e-5 of the leaf's largest magnitude + 1e-12;
- the port's fp32 step itself: loss and components rtol 1e-4 / atol 1e-6;
  each parameter's change and each momentum buffer within 1e-3 of the JAX
  leaf's largest magnitude plus the S step's floors.

The depthwise kernels are in the decayed group, and SEBlock's and DPBlock's
biases in the bias group, as the JAX groups put them.
"""

import os
from functools import partial

import numpy as np
import pytest
import torch

import jax

from test_torch_train_step import (
    EPOCHS, NC, S_SOLVER, _batch, _jax_leaves, _train_variables, check_mid_schedule_step,
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

from torch_port_utils import REPO_ROOT, jax_in_float64

IMG = 128
LITE_S = os.path.join(REPO_ROOT, "configs", "yolov6_lite", "yolov6_lite_s.py")
LOSS_KW = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=4, fpn_strides=(8, 16, 32, 64),
               use_dfl=False, reg_max=0, iou_type="siou")
FLOAT64_REL, FLOAT64_FLOOR = 5e-5, 1e-12


def _make_cfg(config_cls):
    return config_cls.fromfile(LITE_S)


def _port_float64_momentum(variables, use_atss, weight_decay):
    """The first applied step's momentum buffers, ``g + decay·w`` on the
    port's decayed group, with the port's gradients in float64."""
    model = build_model(_make_cfg(Config), num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.double().train()
    images, targets = _batch(img=IMG)
    head, _ = model(torch.from_numpy(images).permute(0, 3, 1, 2).double() / 255.0)
    scores, distri = flatten_head_outputs(head)
    feats_hw = [tuple(c.shape[2:4]) for c in head["cls"]]
    loss, _ = ComputeLoss(**LOSS_KW)(feats_hw, scores.double(), distri.double(),
                                     torch.from_numpy(targets), IMG, IMG, use_atss)
    loss.backward()
    groups = param_groups(model)
    return {n: (p.grad + weight_decay * p.detach() * (groups[n] == GROUP_WEIGHT)).numpy()
            for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def jax_lite_s():
    """The JAX Lite-S, its variables and its step, shared by both branches."""
    jmodel, variables = _train_variables(70, _make_cfg, IMG)
    solver = scale_hyperparams_for_batch(S_SOLVER, 32)
    jstep = jax_make_train_step(
        jmodel, JaxComputeLoss(**LOSS_KW), build_param_groups(variables["params"]), solver,
        max_stepnum=100, epochs=EPOCHS, batch_size=32, warmup_stepnum=0, img_size=(IMG, IMG))
    return variables, solver, jstep


@pytest.mark.parametrize("use_atss", [False, True], ids=["tal", "atss"])
def test_train_step_matches_jax_lite_s(jax_lite_s, use_atss):
    head = _make_cfg(Config).model.head
    assert (head.iou_type, head.use_dfl, tuple(head.strides), head.atss_warmup_epoch) == (
        LOSS_KW["iou_type"], False, LOSS_KW["fpn_strides"], 4)
    variables, solver, jstep = jax_lite_s
    jstep64 = jax_in_float64(partial(jstep.eager_fn, use_atss=use_atss))
    step, jstate = check_mid_schedule_step(
        lambda *args, use_atss: jstep64(*args), variables, 32, 0, _make_cfg, LOSS_KW, img=IMG,
        use_atss=use_atss)
    assert step.model.strides == LOSS_KW["fpn_strides"]

    raw = jax.device_get(jstate.opt.momentum_buf)
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(raw)} == {np.dtype(np.float64)}
    j_momentum = _jax_leaves({"params": raw})  # as float32: 6e-8 of each value
    port64 = _port_float64_momentum(variables, use_atss, solver["weight_decay"])
    assert set(port64) == set(j_momentum)
    for key, want in j_momentum.items():
        err = float(np.abs(port64[key] - want).max())
        assert err <= FLOAT64_REL * float(np.abs(want).max()) + FLOAT64_FLOOR, (key, err)

    groups = param_groups(step.model)
    assert groups["backbone.lite_effiblock_1.0.conv_dw_1.block.conv.weight"] == GROUP_WEIGHT
    biases = [n for n in groups if n.endswith(("se.conv1.bias", "conv_dw_1.bias",
                                                  "conv_pw_1.bias"))]
    assert biases and all(groups[n] == GROUP_BIAS for n in biases)
