"""The port's QAT step (a masked RepOpt step with the conv inputs
fake-quantised under frozen ranges) against the JAX step with
``quant_collection`` and ``grad_masks``, on the CPU: small S in the
``yolov6s_opt_qat`` config (RealVGG blocks, the RepPAN neck; depth 0.1,
width 0.125) at 64 px, on the S solver, one applied step at epoch 1 of 10
from counters past the warmup, by tests/test_torch_train_step.py's
``check_mid_schedule_step``, on the accumulation branch (``batch_size=32``).

The ranges are the JAX package's ``calibrate`` of the seeded train graph
(eval mode, two batches), carried over by ``quant_from_jax``; the masks
come from tests/test_torch_train_step_repopt.py's seeded scales. The
reference is the JAX step evaluated in float64
(``torch_port_utils.jax_in_float64``), with the checks of the RepOpt step
test:

- the port's gradients computed in float64 (its model and ComputeLoss in
  float64, the fake quantisation then in float64 too), masked, plus the
  decay of its weight group, equal each JAX momentum buffer within 5e-5 of
  the leaf's largest magnitude + 1e-12;
- the port's fp32 step itself: loss and components rtol 1e-4 / atol 1e-6;
  each parameter's change and each momentum buffer within 1e-3 of the JAX
  leaf's largest magnitude plus a floor of one fp32 ulp of the step's
  largest gradient; the EMA by ``check_ema_against_jax``.

The ranges are unchanged by the step, bit for bit, and the same step
without them moves the parameters otherwise. JAX's quant mode is global:
the JAX work runs inside a fixture that ends with ``set_quant_mode(False)``.
"""

import os
from functools import partial

import numpy as np
import pytest
import torch

import jax

from test_torch_train_step import (
    EPOCHS, IMG, S_SOLVER, _batch, _jax_leaves, _train_variables, check_ema_against_jax,
    check_mid_schedule_step,
)
from test_torch_train_step_repopt import _scales

from yolov6_tpu.core.train_step import make_train_step as jax_make_train_step
from yolov6_tpu.losses.loss import ComputeLoss as JaxComputeLoss
from yolov6_tpu.quant import set_quant_mode
from yolov6_tpu.quant.ptq import calibrate as jax_calibrate
from yolov6_tpu.solver import repoptimizer as jrepopt
from yolov6_tpu.solver.build import build_param_groups

from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.models.effidehead import flatten_head_outputs
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.quant.state import quant_mode
from yolov6_tpu_torch.solver import repoptimizer as trepopt
from yolov6_tpu_torch.solver.build import GROUP_WEIGHT, param_groups, scale_hyperparams_for_batch
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import quant_from_jax, state_dict_from_jax

from torch_port_utils import REPO_ROOT, jax_in_float64, small_config

S_OPT_QAT = os.path.join(REPO_ROOT, "configs", "repopt", "yolov6s_opt_qat.py")
NC = 3
LOSS_KW = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=False, reg_max=0,
               iou_type="giou")
FLOAT64_REL, FLOAT64_FLOOR = 5e-5, 1e-12


@pytest.fixture
def jax_quant():
    yield
    set_quant_mode(False)


def _make_cfg(config_cls):
    return small_config(config_cls, S_OPT_QAT)


def _port_model(variables):
    model = build_model(_make_cfg(Config), num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _port_float64_momentum(variables, masks, amax, weight_decay):
    """The first applied step's momentum buffers, ``mask·g + decay·w`` on
    the port's decayed group, with the port's quantised forward and its
    gradients in float64."""
    model = _port_model(variables).double().train()
    images, targets = _batch()
    x = torch.from_numpy(images).permute(0, 3, 1, 2).double() / 255.0
    with quant_mode(model, amax):
        head, _ = model(x)
    scores, distri = flatten_head_outputs(head)
    feats_hw = [tuple(c.shape[2:4]) for c in head["cls"]]
    loss, _ = ComputeLoss(**LOSS_KW)(feats_hw, scores.double(), distri.double(),
                                     torch.from_numpy(targets), IMG, IMG, False)
    loss.backward()
    trepopt.apply_gradient_masks(model, masks)
    groups = param_groups(model)
    return {n: (p.grad + weight_decay * p.detach() * (groups[n] == GROUP_WEIGHT)).numpy()
            for n, p in model.named_parameters()}


def test_masked_qat_step_matches_jax_small_s_opt_qat(jax_quant):
    cfg = _make_cfg(Config)
    assert cfg.training_mode == "repopt" and cfg.model.head.iou_type == LOSS_KW["iou_type"]
    jmodel, variables = _train_variables(83, _make_cfg)
    calibrated = jax_calibrate(jmodel, dict(variables), [_batch(seed=s)[0] for s in (1, 2)])
    quant = calibrated["quant"]  # JAX's mode is now on, with these frozen ranges
    amax = quant_from_jax(quant)
    jscales = _scales(variables["params"], seed=84)
    scales = {".".join(path): sc for path, sc in jscales.items()}
    jmasks = jrepopt.generate_gradient_masks(variables["params"], jscales)
    solver = scale_hyperparams_for_batch(S_SOLVER, 32)
    jstep = jax_make_train_step(
        jmodel, JaxComputeLoss(**LOSS_KW), build_param_groups(variables["params"]), solver,
        max_stepnum=100, epochs=EPOCHS, batch_size=32, warmup_stepnum=0, img_size=(IMG, IMG),
        grad_masks=jmasks, quant_collection=quant)
    jstep64 = jax_in_float64(partial(jstep.eager_fn, use_atss=False))

    masks = trepopt.generate_gradient_masks(_port_model(variables), scales)
    frozen = {k: v.clone() for k, v in amax.items()}

    def port_step(**kw):
        return make_train_step(_port_model(variables), ComputeLoss(**LOSS_KW), solver, 100,
                               EPOCHS, 32, 0, (IMG, IMG), half=False, device="cpu",
                               grad_masks=masks, **kw)

    step, jstate = check_mid_schedule_step(
        lambda *args, use_atss: jstep64(*args), variables, 32, 0, _make_cfg, LOSS_KW,
        port_step=lambda: port_step(quant=dict(amax=amax, num_bits=8, skip_patterns=[])),
        floor_scales_with_grad=True)
    check_ema_against_jax(step, jstate, "QAT")
    assert set(step.quant["amax"]) == set(frozen) and len(frozen) > 30
    for key, value in step.quant["amax"].items():
        assert torch.equal(value, frozen[key]) and torch.equal(amax[key], frozen[key]), key
    assert all(not m._forward_pre_hooks for m in step.model.modules())

    raw = jax.device_get(jstate.opt.momentum_buf)
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(raw)} == {np.dtype(np.float64)}
    j_momentum = _jax_leaves({"params": raw})
    port64 = _port_float64_momentum(variables, masks, amax, solver["weight_decay"])
    assert set(port64) == set(j_momentum)
    for key, want in j_momentum.items():
        err = float(np.abs(port64[key] - want).max())
        assert err <= FLOAT64_REL * float(np.abs(want).max()) + FLOAT64_FLOOR, (key, err)

    # without the ranges the same step moves the parameters otherwise
    plain = port_step()
    plain.step.fill_(int(step.step) - 1)
    plain.accum_count.fill_(1)
    plain(*_batch(), 1)
    name = "backbone.ERBlock_2.0.conv.weight"
    assert not torch.allclose(plain.momentum[name], step.momentum[name], rtol=1e-3)
