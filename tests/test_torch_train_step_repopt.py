"""The port's masked RepOpt step against the JAX step with ``grad_masks``, on
the CPU: small S in RepOpt mode (configs/repopt/yolov6s_opt.py: RealVGG
blocks, the RepPAN neck; depth 0.1, width 0.125) at 64 px on its loss (TAL,
no DFL, GIoU), one applied step at epoch 1 of 10 from counters past the
warmup, by tests/test_torch_train_step.py's ``check_mid_schedule_step``, on
the accumulation branch (``batch_size=32``). The masks come from seeded
scales in [0.5, 1.5] for every block (``s_conv²`` off the centre tap, so
that they move every RealVGG conv's update): the JAX package's
``generate_gradient_masks`` for its step, the port's for the port's.

The reference is the JAX step evaluated in float64
(``torch_port_utils.jax_in_float64``), as for M, P6, lite and QA. Two checks
against it, those of tests/test_torch_train_step_qa.py:

- the port's gradients computed in float64 (its model and ComputeLoss in
  float64), masked, plus the decay of its weight group, equal each JAX
  momentum buffer within 5e-5 of the leaf's largest magnitude + 1e-12;
- the port's fp32 step itself: loss and components rtol 1e-4 / atol 1e-6;
  each parameter's change and each momentum buffer within 1e-3 of the JAX
  leaf's largest magnitude plus a floor of one fp32 ulp of the step's
  largest gradient.

The only whole-step replay of this slice; a file of its own, so that the
JAX work runs on its own worker.
"""

import os
from functools import partial

import numpy as np
import torch

import jax
from flax.traverse_util import flatten_dict

from test_torch_train_step import (
    EPOCHS, IMG, NC, S_SOLVER, _batch, _jax_leaves, _train_variables, check_mid_schedule_step,
)

from yolov6_tpu.core.train_step import make_train_step as jax_make_train_step
from yolov6_tpu.losses.loss import ComputeLoss as JaxComputeLoss
from yolov6_tpu.solver import repoptimizer as jrepopt
from yolov6_tpu.solver.build import build_param_groups

from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.models.effidehead import flatten_head_outputs
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver import repoptimizer as trepopt
from yolov6_tpu_torch.solver.build import GROUP_WEIGHT, param_groups, scale_hyperparams_for_batch
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import REPO_ROOT, jax_in_float64, small_config

S_OPT = os.path.join(REPO_ROOT, "configs", "repopt", "yolov6s_opt.py")
LOSS_KW = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=False, reg_max=0,
               iou_type="giou")
FLOAT64_REL, FLOAT64_FLOOR = 5e-5, 1e-12


def _make_cfg(config_cls):
    return small_config(config_cls, S_OPT)


def _scales(params, seed=81):
    """Seeded scales for every RealVGG block: (s_id, s_1x1, s_conv) where
    in == out and the stride is 1, else (s_1x1, s_conv)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, sub in sorted(jrepopt.find_repopt_blocks(params).items()):
        cin, cout = sub["conv"]["kernel"].shape[2:]
        n = 3 if cin == cout else 2
        out[path] = tuple(rng.uniform(0.5, 1.5, cout).astype(np.float32) for _ in range(n))
    return out


def _port_model(variables):
    model = build_model(_make_cfg(Config), num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _port_float64_momentum(variables, masks, weight_decay):
    """The first applied step's momentum buffers, ``mask·g + decay·w`` on
    the port's decayed group, with the port's gradients in float64."""
    model = _port_model(variables).double().train()
    images, targets = _batch()
    head, _ = model(torch.from_numpy(images).permute(0, 3, 1, 2).double() / 255.0)
    scores, distri = flatten_head_outputs(head)
    feats_hw = [tuple(c.shape[2:4]) for c in head["cls"]]
    loss, _ = ComputeLoss(**LOSS_KW)(feats_hw, scores.double(), distri.double(),
                                     torch.from_numpy(targets), IMG, IMG, False)
    loss.backward()
    trepopt.apply_gradient_masks(model, masks)
    groups = param_groups(model)
    return {n: (p.grad + weight_decay * p.detach() * (groups[n] == GROUP_WEIGHT)).numpy()
            for n, p in model.named_parameters()}


def test_masked_repopt_step_matches_jax_small_s_opt():
    cfg = _make_cfg(Config)
    assert cfg.training_mode == "repopt" and cfg.model.head.iou_type == LOSS_KW["iou_type"]
    jmodel, variables = _train_variables(82, _make_cfg)
    jscales = _scales(variables["params"])
    scales = {".".join(path): sc for path, sc in jscales.items()}
    jmasks = jrepopt.generate_gradient_masks(variables["params"], jscales)
    solver = scale_hyperparams_for_batch(S_SOLVER, 32)
    jstep = jax_make_train_step(
        jmodel, JaxComputeLoss(**LOSS_KW), build_param_groups(variables["params"]), solver,
        max_stepnum=100, epochs=EPOCHS, batch_size=32, warmup_stepnum=0, img_size=(IMG, IMG),
        grad_masks=jmasks)
    jstep64 = jax_in_float64(partial(jstep.eager_fn, use_atss=False))

    masks = trepopt.generate_gradient_masks(_port_model(variables), scales)
    assert len(masks) == len(jscales) > 10
    for path, m in flatten_dict(jmasks).items():
        name = ".".join(path[:-1]) + ".weight"
        if name in masks:
            np.testing.assert_array_equal(masks[name].numpy(), np.transpose(m, (3, 2, 0, 1)))

    def port_step():
        return make_train_step(_port_model(variables), ComputeLoss(**LOSS_KW), solver, 100,
                               EPOCHS, 32, 0, (IMG, IMG), half=False, device="cpu",
                               grad_masks=masks)

    step, jstate = check_mid_schedule_step(
        lambda *args, use_atss: jstep64(*args), variables, 32, 0, _make_cfg, LOSS_KW,
        port_step=port_step, floor_scales_with_grad=True)
    assert step._mask is not None and float(step._mask.min()) > 0.2

    raw = jax.device_get(jstate.opt.momentum_buf)
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(raw)} == {np.dtype(np.float64)}
    j_momentum = _jax_leaves({"params": raw})
    port64 = _port_float64_momentum(variables, masks, solver["weight_decay"])
    assert set(port64) == set(j_momentum)
    for key, want in j_momentum.items():
        err = float(np.abs(port64[key] - want).max())
        assert err <= FLOAT64_REL * float(np.abs(want).max()) + FLOAT64_FLOOR, (key, err)

    # without the masks the same step moves the RealVGG convs otherwise
    plain = make_train_step(_port_model(variables), ComputeLoss(**LOSS_KW), solver, 100, EPOCHS,
                            32, 0, (IMG, IMG), half=False, device="cpu")
    plain.step.fill_(int(step.step) - 1)
    plain.accum_count.fill_(1)
    plain(*_batch(), 1)
    name = next(iter(masks))
    assert not torch.allclose(plain.momentum[name], step.momentum[name], rtol=1e-2)
