"""The port's training step on the P6 graphs against the JAX package's step,
on the CPU: one applied step at epoch 1 of 10 (weight LR 0.0098) from
counters past the warmup, by tests/test_torch_train_step.py's
``check_mid_schedule_step``, on the accumulation branch (``batch_size=32``).

Small N6 (depth 0.1, width 0.125, RepVGG blocks, SimCSPSPPF) on N6's loss:
TAL, no DFL, SIoU (configs/yolov6n6.py). Small L6 (``conv_silu``, BepC3
stages with their alphas) on L6's loss with DFL (reg_max 16) and GIoU, on
the ATSS branch, which P6 trains its first 4 epochs on
(``atss_warmup_epoch``): top 9 anchors per level over the four levels. Both
at 256 px, so that stride 64 has a 4x4 grid, with the four strides 8-64 in
the loss.

The reference is the JAX step evaluated in float64
(``torch_port_utils.jax_in_float64``), as for M in
tests/test_torch_train_step_csp.py: at 256 px the fp32 gradients of both
packages are noisy on convs ahead of a train-mode BN over few positions (a
4x4 or 8x8 grid, and SimCSPSPPF's serial 5x5 pools over a 4x4 grid make
its channels nearly constant). Measured on the CPU: the JAX fp32 step off
the float64 step by up to 3.9e-2 of a leaf's largest magnitude (N6,
``ERBlock_6.2.cspsppf.cv7``'s conv), the port's fp32 step by up to
5.0e-2 (N6, ``neck.downsample2``'s conv) and 1.4e-3 (L6, a BottleRep
alpha). Two checks against that float64 step:

- the port's gradients computed in float64 (its model and ComputeLoss in
  float64 but for the DFL projection, which works in fp32 as in training),
  plus the decay of its weight group, equal each JAX momentum buffer within
  5e-5 of the leaf's largest magnitude + 1e-12 (measured: N6 1.4e-6, L6
  1.3e-5 on the stage-6 BottleRep alpha, through the fp32 DFL). A wrong
  gradient, loss weight, level, stride or decay group fails here;
- the port's fp32 step itself: loss and components rtol 1e-4 / atol 1e-6;
  each parameter's change and each momentum buffer within ``rel`` of the
  JAX leaf's largest magnitude plus the S step's floors: 1e-2 for L6 (the M
  step's), 6e-2 for N6 (the measured 5.0e-2 above).
"""

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
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver.build import (
    GROUP_BIAS, GROUP_WEIGHT, param_groups, scale_hyperparams_for_batch,
)
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import P6_CONFIGS, jax_in_float64, small_config

IMG = 256
STRIDES = (8, 16, 32, 64)
FLOAT64_REL, FLOAT64_FLOOR = 5e-5, 1e-12
# name -> (loss, assigner, seed, the fp32 step's tolerance against float64)
CASES = {
    "n6": (dict(use_dfl=False, reg_max=0, iou_type="siou"), False, 60, 6e-2),
    "l6": (dict(use_dfl=True, reg_max=16, iou_type="giou"), True, 61, 1e-2),
}


def _port_float64_momentum(make_cfg, variables, loss_kw, use_atss, weight_decay):
    """The first applied step's momentum buffers, ``g + decay·w`` on the
    port's decayed group, with the port's gradients in float64."""
    model = build_model(make_cfg(Config), num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.double().train()
    images, targets = _batch(img=IMG)
    x = (torch.from_numpy(images).permute(0, 3, 1, 2).double() / 255.0).contiguous()
    head, _ = model(x)

    def flat(maps):  # flatten_head_outputs' layout, kept in float64
        return torch.cat([m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, m.shape[1])
                          for m in maps], 1)

    scores, distri = torch.sigmoid(flat(head["cls"])), flat(head["reg"])
    feats_hw = [tuple(c.shape[2:4]) for c in head["cls"]]
    loss, _ = ComputeLoss(**loss_kw)(feats_hw, scores, distri, torch.from_numpy(targets), IMG,
                                     IMG, use_atss)
    loss.backward()
    groups = param_groups(model)
    return {n: (p.grad + weight_decay * p.detach() * (groups[n] == GROUP_WEIGHT)).numpy()
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["n6", "l6"])
def test_train_step_matches_jax_small_p6(name):
    loss_cfg, use_atss, seed, rel = CASES[name]
    loss_kw = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=4, fpn_strides=STRIDES,
                   **loss_cfg)
    make_cfg = lambda config_cls: small_config(config_cls, P6_CONFIGS[name])  # noqa: E731
    jmodel, variables = _train_variables(seed, make_cfg, IMG)
    batch_size = 32
    solver = scale_hyperparams_for_batch(S_SOLVER, batch_size)
    jstep = jax_make_train_step(
        jmodel, JaxComputeLoss(**loss_kw), build_param_groups(variables["params"]), solver,
        max_stepnum=100, epochs=EPOCHS, batch_size=batch_size, warmup_stepnum=0,
        img_size=(IMG, IMG))
    jstep64 = jax_in_float64(partial(jstep.eager_fn, use_atss=use_atss))
    step, jstate = check_mid_schedule_step(
        lambda *args, use_atss: jstep64(*args), variables, batch_size, 0, make_cfg, loss_kw,
        rel=rel, img=IMG, use_atss=use_atss)
    assert step.model.strides == STRIDES

    raw = jax.device_get(jstate.opt.momentum_buf)
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(raw)} == {np.dtype(np.float64)}
    j_momentum = _jax_leaves({"params": raw})  # as float32: 6e-8 of each value
    port64 = _port_float64_momentum(make_cfg, variables, loss_kw, use_atss,
                                    solver["weight_decay"])
    assert set(port64) == set(j_momentum)
    for key, want in j_momentum.items():
        err = float(np.abs(port64[key] - want).max())
        assert err <= FLOAT64_REL * float(np.abs(want).max()) + FLOAT64_FLOOR, (key, err)

    alphas = [n for n in step.param_names if n.endswith(".alpha")]
    assert len(alphas) == (11 if name == "l6" else 0)
    groups = param_groups(step.model)
    assert all(groups[n] == GROUP_BIAS for n in alphas)
