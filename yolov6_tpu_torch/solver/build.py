"""Optimizer and LR schedule (port of yolov6_tpu/solver/build.py:22-173).

Three parameter groups as the JAX package's: BN weights without decay, conv
and transpose weights and RepOpt's ScaleLayer scales with ``weight_decay``,
every bias and every BottleRep ``alpha`` with the warmup bias LR. The schedule is a function of device tensors (the step
counter), and the update a function over lists of tensors, so that a train
step needs no value on the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from yolov6_tpu_torch.layers.common import ScaleLayer

GROUP_BN = 0      # BatchNorm weights (gammas): no weight decay
GROUP_WEIGHT = 1  # conv and transposed-conv weights, ScaleLayer scales: decayed
GROUP_BIAS = 2    # biases, BottleRep alphas: no decay, warmup_bias_lr


def param_groups(model: nn.Module) -> Dict[str, int]:
    """Parameter name -> group id, by the type of the owning module, as
    upstream's ``build_optimizer`` sorts them (JAX: build.py:22-42 sorts the
    same leaves by name). ``rbr_identity.weight`` is a BN gamma. A
    BottleRep's ``alpha`` joins the biases, and a ScaleLayer's ``weight``
    the decayed weights, as in the JAX step (its ``param_group_id`` puts
    every ``weight`` leaf there)."""
    groups = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if leaf in ("bias", "alpha"):
                groups[name] = GROUP_BIAS
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                groups[name] = GROUP_BN
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, ScaleLayer)):
                groups[name] = GROUP_WEIGHT
            else:
                raise TypeError(f"no parameter group for {name} ({type(mod).__name__})")
    return groups


def lr_lambda(epoch, epochs: int, lrf: float, scheduler: str = "Cosine"):
    """Per-epoch LR factor (JAX: build.py:47-53)."""
    if scheduler == "Cosine":
        return ((1 - torch.cos(epoch * math.pi / epochs)) / 2) * (lrf - 1) + 1
    if scheduler == "Constant":
        return torch.ones_like(epoch)
    raise ValueError(f"unknown lr scheduler {scheduler!r}")


def warmup_lr_momentum(curr_step: torch.Tensor, epoch, warmup_stepnum: int, lr0: float,
                       lrf: float, epochs: int, warmup_bias_lr: float, warmup_momentum: float,
                       momentum: float, scheduler: str = "Cosine"):
    """Per-step (lr_bn, lr_weight, lr_bias, momentum) as float32 tensors, with
    linear warmup (JAX: build.py:56-76). ``curr_step`` is an int tensor and
    ``epoch`` a number or a tensor."""
    epoch = torch.as_tensor(epoch, dtype=torch.float32, device=curr_step.device)
    base = lr0 * lr_lambda(epoch, epochs, lrf, scheduler)
    frac = (curr_step / max(warmup_stepnum, 1)).clamp(0.0, 1.0)
    in_warmup = curr_step <= warmup_stepnum
    lr_main = torch.where(in_warmup, frac * base, base)
    lr_bias = torch.where(in_warmup, warmup_bias_lr + frac * (base - warmup_bias_lr), base)
    mom = torch.where(in_warmup, warmup_momentum + frac * (momentum - warmup_momentum),
                      torch.full_like(frac, momentum))
    return lr_main, lr_main, lr_bias, mom


def warmup_accumulate(curr_step: torch.Tensor, warmup_stepnum: int, batch_size: int,
                      nominal_batch: int = 64) -> torch.Tensor:
    """Gradient-accumulation count, interpolated during warmup (JAX:
    build.py:108-115), an int32 tensor. The interpolation rounds in tensors,
    half to even, as ``jnp.round`` does."""
    target = max(1, round(nominal_batch / batch_size))
    frac = (curr_step / max(warmup_stepnum, 1)).clamp(0.0, 1.0)
    warm = torch.round(1 + frac * (nominal_batch / batch_size - 1))
    acc = torch.where(curr_step <= warmup_stepnum, warm.clamp(min=1), float(target))
    return acc.to(torch.int32)


def sgd_update(grads: Sequence[torch.Tensor], momentum_bufs: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor], group_ids: Sequence[int], lr_bn, lr_weight,
               lr_bias, momentum, weight_decay: float):
    """torch-SGD-compatible Nesterov update over lists of tensors (JAX:
    build.py:128-163): the decay is added to the gradient, then
    ``buf = m·buf + g`` and ``p -= lr·(g + m·buf)``. Returns (new params, new
    buffers), fp32; the inputs are not changed."""
    lrs = {GROUP_BN: lr_bn, GROUP_WEIGHT: lr_weight, GROUP_BIAS: lr_bias}
    new_p: List[torch.Tensor] = [None] * len(params)
    new_b: List[torch.Tensor] = [None] * len(params)
    for gid, lr in lrs.items():
        sel = [i for i, g in enumerate(group_ids) if g == gid]
        if not sel:
            continue
        g = [grads[i].float() for i in sel]
        p = [params[i] for i in sel]
        if gid == GROUP_WEIGHT and weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        buf = torch._foreach_add(torch._foreach_mul([momentum_bufs[i] for i in sel], momentum), g)
        step_dir = torch._foreach_add(g, torch._foreach_mul(buf, momentum))
        upd = torch._foreach_sub(p, torch._foreach_mul(step_dir, lr))
        for k, i in enumerate(sel):
            new_p[i], new_b[i] = upd[k], buf[k]
    return new_p, new_b


def scale_hyperparams_for_batch(solver_cfg: Dict, batch_size: int,
                                world_batch: Optional[int] = None):
    """Weight-decay batch rescale, and with ``world_batch`` (the trainer's
    ``--bs_per_device`` times the device count) the LR rescale
    ``lr0 · batch_size / world_batch`` (JAX: build.py:166-173)."""
    accumulate = max(1, round(64 / batch_size))
    out = dict(solver_cfg)
    out["weight_decay"] = solver_cfg["weight_decay"] * batch_size * accumulate / 64
    if world_batch:
        out["lr0"] = solver_cfg["lr0"] * batch_size / world_batch
    return out
