"""The training step: forward, loss (with the assignment), backward, SGD with
warmup and accumulation, EMA, and the finite guards (port of
yolov6_tpu/core/train_step.py:79-259).

The JAX step is a pure function of a TrainState; here the state lives in the
step object and is updated in place. Parameters, BN statistics, gradients,
momentum, the gradient accumulator and the EMA each live in one flat device
buffer, the model's tensors being views into it, so the guards and the
branches are a few whole-buffer ``torch.where`` selects on device booleans:
the step reads no value on the host, as the jitted JAX step reads none.
Parameters are ordered by group (BN weights, weights, biases), so a group is
one slice of the buffer.

Data parallel (``parallel/dist.py``): each rank steps on its slice of the
global batch. The BatchNorms are synchronised (``layers/sync_bn.py``), the
loss normalisers are global (``losses/``), so each rank's loss is its share
of the global batch's, and one sum over the ranks of the flat gradient
buffer before the guards gives every rank the JAX step's gradient: the
guards, the accumulation, the masks and SGD then run alike on every rank.
The buffers start from rank 0's, and the returned loss and components are
summed over the ranks.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from yolov6_tpu_torch.layers.sync_bn import convert_sync_batchnorm
from yolov6_tpu_torch.models.effidehead import flatten_head_outputs
from yolov6_tpu_torch.models.heads.effidehead_fuseab import flatten_ab_outputs
from yolov6_tpu_torch.parallel.dist import all_reduce_sum_, broadcast_
from yolov6_tpu_torch.quant.state import quant_mode
from yolov6_tpu_torch.solver.build import (
    param_groups,
    sgd_update,
    warmup_accumulate,
    warmup_lr_momentum,
)
from yolov6_tpu_torch.utils.device import resolve_device
from yolov6_tpu_torch.utils.ema import ema_update


def _views(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Consecutive views of ``flat`` shaped as ``like``."""
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def _flatten_into(tensors: Sequence[torch.Tensor], dtype, device) -> torch.Tensor:
    """Copy ``tensors`` into one new flat buffer and make each a view of it
    (``.data`` is rebound, so the tensor objects stay the same)."""
    flat = torch.empty(sum(t.numel() for t in tensors), dtype=dtype, device=device)
    for t, view in zip(tensors, _views(flat, tensors)):
        view.copy_(t.detach())
        t.data = view
    return flat


class TrainStep:
    """The state of a training run and its step; ``make_train_step`` builds it.

    State: ``model`` (train form, fp32 parameters, train mode), ``momentum``
    and ``grad_accum`` (name -> fp32 tensor, views of flat buffers),
    ``accum_count``, ``step`` and ``ema_updates`` (int32 device scalars), and
    ``ema``, an fp32 copy of the model kept in eval mode, for
    ``layers/reparam.py::fold_to_deploy(step.ema.state_dict())``. The
    model's tensors and gradients are views into the step's buffers: do not
    move or cast the model, or set its gradients to ``None``
    (``model.zero_grad()``), while the step owns it; a step then raises.
    ``load_state_dict`` is fine. ``max_stepnum`` is taken to match the JAX
    signature and unused.

    The training recipes: with ``compute_loss_ab`` (fuse-AB) the loss is the
    anchor-free loss plus the anchor-based one, and so are the components;
    with ``teacher = (teacher_model, distill_loss)`` the teacher's forward
    runs in eval mode without autograd, under the student's autocast, and
    ``distill_loss`` (``ComputeLossDistill[NS]``, then ``compute_loss``)
    takes both models' head and neck maps and the epoch. The teacher is not
    part of the step's state.

    RepOpt: ``grad_masks`` (parameter name -> mask of its shape,
    solver/repoptimizer.py::generate_gradient_masks) multiply the step's
    gradients before the finite guards, the accumulation and SGD, as the
    JAX step applies its masks to ``value_and_grad``'s gradients; they live
    in one flat buffer beside the gradients', ones where no mask is given.

    QAT: ``quant = dict(amax=..., num_bits=..., skip_patterns=...)`` runs
    the model's forward under ``quant/state.py::quant_mode`` with those
    frozen ranges (JAX: train_step.py:110-112, the ``quant_collection``):
    each conv's input is fake-quantised, in fp32 inside the bf16 autocast,
    and the straight-through round passes the gradient. The ranges are
    not part of the step's state and never change; the teacher and the EMA
    run without them."""

    def __init__(self, model: nn.Module, compute_loss, solver_cfg: Dict, max_stepnum: int,
                 epochs: int, batch_size: int, warmup_stepnum: int, img_size: Tuple[int, int],
                 half: bool = True, device="cuda", compute_loss_ab=None, teacher=None,
                 grad_masks=None, quant: Optional[Mapping] = None):
        device = resolve_device(device)
        if teacher is not None and compute_loss_ab is not None:
            raise ValueError("a distillation step takes no anchor-based loss (fuse-AB)")
        convert_sync_batchnorm(model)
        named = list(model.named_parameters())
        for name, p in named:
            if p.device.type != device.type or p.dtype != torch.float32:
                raise ValueError(f"parameter {name} is {p.dtype} on {p.device}; the step "
                                 f"needs fp32 parameters on {device}")
        self.model, self.compute_loss, self.device = model, compute_loss, device
        self.compute_loss_ab, self.teacher = compute_loss_ab, None
        self.quant = None
        if quant is not None:
            self.quant = dict(quant)
            self.quant["amax"] = {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
                                  for k, v in quant["amax"].items()}
            quant_mode(model, **self.quant).remove()  # a conv without a range raises here
        if teacher is not None:
            self.teacher, self.compute_loss = teacher
            self.teacher.eval().requires_grad_(False)
        self.solver_cfg = dict(solver_cfg)
        self.epochs, self.batch_size = epochs, batch_size
        self.warmup_stepnum, self.img_size, self.half = warmup_stepnum, tuple(img_size), half
        # with a batch of at least the nominal 64 the accumulation count is 1
        # for the whole run: no accumulator and no selects on it
        self.single_step = round(64 / batch_size) <= 1

        self.ema = copy.deepcopy(model).float().eval().requires_grad_(False)

        groups = param_groups(model)
        order = sorted(range(len(named)), key=lambda i: groups[named[i][0]])
        self.param_names = [named[i][0] for i in order]
        params = [named[i][1] for i in order]
        ema_params = dict(self.ema.named_parameters())
        ema_buffers = dict(self.ema.named_buffers())
        float_bufs = [(n, b) for n, b in model.named_buffers() if b.is_floating_point()]
        int_bufs = [(n, b) for n, b in model.named_buffers() if not b.is_floating_point()]

        f32 = dict(dtype=torch.float32, device=device)
        self._param = _flatten_into(params, **f32)
        self._stats = _flatten_into([b for _, b in float_bufs], **f32)
        self._counts = _flatten_into([b for _, b in int_bufs], torch.int64, device)
        self._ema = [
            _flatten_into([ema_params[n] for n in self.param_names], **f32),
            _flatten_into([ema_buffers[n] for n, _ in float_bufs], **f32),
            _flatten_into([ema_buffers[n] for n, _ in int_bufs], torch.int64, device),
        ]
        for flat in [self._param, self._stats, self._counts, *self._ema]:
            broadcast_(flat)
        self._stats_before = torch.empty_like(self._stats)
        self._grad = torch.zeros_like(self._param)
        self._momentum = torch.zeros_like(self._param)
        self._accum = torch.zeros_like(self._param)
        # gradients accumulate in place into views of one buffer
        grads = _views(self._grad, params)
        for p, g in zip(params, grads):
            p.grad = g
        self._params, self._grads = params, grads
        self._bufs = [b for _, b in float_bufs + int_bufs]
        self._ptrs = [t.data_ptr() for t in params + self._bufs]
        self._mask = None
        if grad_masks:
            unknown = sorted(set(grad_masks) - set(self.param_names))
            if unknown:
                raise ValueError(f"gradient masks for parameters the model lacks: {unknown}")
            self._mask = torch.ones_like(self._param)
            for name, view in zip(self.param_names, _views(self._mask, params)):
                if name in grad_masks:
                    view.copy_(torch.as_tensor(grad_masks[name]).reshape(view.shape))
        self.momentum = dict(zip(self.param_names, _views(self._momentum, params)))
        self.grad_accum = dict(zip(self.param_names, _views(self._accum, params)))

        # one slice of the flat buffers per non-empty group, in group order
        ids = [groups[n] for n in self.param_names]
        self._group_ids: List[int] = sorted(set(ids))
        sizes = [sum(p.numel() for p, i in zip(params, ids) if i == g) for g in self._group_ids]
        self._split = lambda flat: list(flat.split(sizes))

        zero = torch.zeros((), dtype=torch.int32, device=device)
        self.accum_count, self.step, self.ema_updates = zero.clone(), zero.clone(), zero.clone()

    def __call__(self, images_u8, targets, epoch, use_atss: bool = False):
        """One step on ``images_u8 [b, H, W, 3]`` uint8 NHWC and padded
        ``targets [b, M, 5]``; returns (loss, components [iou, dfl, cls], and
        with a teacher [iou, dfl, cls, cwd]) as device tensors."""
        loss, components = self.forward_backward(images_u8, targets, use_atss, epoch)
        self.update(epoch)
        return loss, components

    def _check_aliasing(self) -> None:
        """Raise if the model's tensors or gradients are no longer views of
        the step's buffers (host pointers only: no device work)."""
        if any(p.grad is not g for p, g in zip(self._params, self._grads)):
            raise ValueError("a parameter's .grad is no longer the step's gradient buffer "
                             "(model.zero_grad() sets it to None); the step would read no "
                             "gradient")
        if [t.data_ptr() for t in self._params + self._bufs] != self._ptrs:
            raise ValueError("the model was moved or cast after make_train_step; the step "
                             "would update buffers the model no longer reads")

    def forward_backward(self, images_u8, targets, use_atss: bool = False, epoch=None):
        """The first half of a step: the forward (BN statistics snapshotted
        first), the loss and the gradients, in the step's gradient buffer.
        ``update`` is the second half. ``epoch`` (a number or a device
        scalar) is read by the distillation loss only."""
        self._check_aliasing()
        if self.teacher is not None and epoch is None:
            raise ValueError("a distillation step needs the epoch: its KD terms decay with it")
        dev = self.device
        images = torch.as_tensor(images_u8, device=dev)
        if tuple(images.shape[1:3]) != self.img_size:
            raise ValueError(f"images are {tuple(images.shape[1:3])}, the step was built for "
                             f"{self.img_size}")
        x = (images.permute(0, 3, 1, 2).float() / 255.0).contiguous()
        targets = torch.as_tensor(targets, device=dev)

        self.model.train()
        self._stats_before.copy_(self._stats)
        self._grad.zero_()
        quant = (quant_mode(self.model, **self.quant) if self.quant is not None
                 else contextlib.nullcontext())
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=self.half):
            with quant:
                head_out, neck_feats = self.model(x)
            if self.teacher is not None:
                self.teacher.eval()
                with torch.no_grad():
                    t_head_out, t_feats = self.teacher(x)
        feats_hw = [tuple(c.shape[2:4]) for c in head_out["cls"]]
        h, w = x.shape[2], x.shape[3]
        if self.teacher is not None:
            loss, components = self.compute_loss(feats_hw, head_out, t_head_out, neck_feats,
                                                 t_feats, targets, epoch, h, w, use_atss)
        else:
            cls_scores, reg_distri = flatten_head_outputs(head_out)
            loss, components = self.compute_loss(feats_hw, cls_scores, reg_distri, targets, h,
                                                 w, use_atss)
            if self.compute_loss_ab is not None:
                detect = self.model.detect
                cls_ab, reg_ab = flatten_ab_outputs(head_out, detect.anchors_init,
                                                    detect.strides, detect.num_anchors)
                loss_ab, comp_ab = self.compute_loss_ab(feats_hw, cls_ab, reg_ab, targets, h, w)
                loss, components = loss + loss_ab, components + comp_ab
        loss.backward()
        all_reduce_sum_(self._grad)
        summed = all_reduce_sum_(torch.cat([loss.detach()[None], components]))
        return summed[0], summed[1:]

    @torch.no_grad()
    def update(self, epoch) -> None:
        """The second half of a step: guards, SGD, accumulation and EMA
        (JAX: train_step.py:156-249), on device values only."""
        sc = self.solver_cfg
        if not torch.is_tensor(epoch):
            epoch = torch.full((), float(epoch), device=self.device)
        lr_bn, lr_w, lr_b, momentum = warmup_lr_momentum(
            self.step, epoch, self.warmup_stepnum, sc["lr0"], sc["lrf"], self.epochs,
            sc["warmup_bias_lr"], sc["warmup_momentum"], sc["momentum"],
            sc.get("lr_scheduler", "Cosine"))
        if self._mask is not None:
            self._grad.mul_(self._mask)

        # a non-finite gradient changes no parameter, momentum or EMA (the
        # reference's GradScaler skips such steps); and BN statistics that
        # went non-finite in the forward, which torch writes in place, go
        # back to the last finite ones, or one bad batch would break every
        # later forward, train and eval
        grads_finite = torch.isfinite(self._grad).all()
        stats_finite = torch.isfinite(self._stats).all()
        self._stats.copy_(torch.where(stats_finite, self._stats, self._stats_before))

        if self.single_step:
            grads, apply = self._grad, grads_finite
        else:
            # a non-finite gradient adds zero
            self._accum.add_(torch.where(grads_finite, self._grad, 0.0))
            self.accum_count += 1
            apply = self.accum_count >= warmup_accumulate(self.step, self.warmup_stepnum,
                                                          self.batch_size)
            grads = self._accum

        split = self._split
        new_params, new_bufs = sgd_update(
            split(grads), split(self._momentum), split(self._param), self._group_ids,
            lr_bn, lr_w, lr_b, momentum, sc["weight_decay"])
        for dst, new in zip(split(self._param) + split(self._momentum), new_params + new_bufs):
            dst.copy_(torch.where(apply, new, dst))
        if not self.single_step:
            self._accum.copy_(torch.where(apply, 0.0, self._accum))
            self.accum_count.copy_(torch.where(apply, 0, self.accum_count))

        self.ema_updates += apply.to(torch.int32)
        model_state = [self._param, self._stats, self._counts]
        for dst, new in zip(self._ema, ema_update(self._ema, model_state, self.ema_updates)):
            dst.copy_(torch.where(apply, new, dst))
        self.step += 1


    def _state_tensors(self) -> Dict[str, torch.Tensor]:
        return {"params": self._param, "bn_stats": self._stats, "bn_counts": self._counts,
                "momentum": self._momentum, "grad_accum": self._accum,
                "ema_params": self._ema[0], "ema_bn_stats": self._ema[1],
                "ema_bn_counts": self._ema[2], "accum_count": self.accum_count,
                "step": self.step, "ema_updates": self.ema_updates}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The step's whole state as CPU copies of its flat buffers (JAX:
        train_step.py:66-76 ``state_to_dict``): parameters (group order), BN
        statistics and counts, momentum, the accumulator, the EMA's three
        buffers, ``accum_count``, ``step`` and ``ema_updates``."""
        return {k: v.detach().to("cpu", copy=True) for k, v in self._state_tensors().items()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy a ``state_dict()`` into the step's buffers in place, so that the
        model and the EMA, views of them, continue from it bit for bit."""
        own = self._state_tensors()
        if set(state) != set(own):
            raise ValueError(f"train state keys {sorted(state)} differ from the step's "
                             f"{sorted(own)}")
        for key, dst in own.items():
            src = state[key]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"train state {key}: {src.dtype} {tuple(src.shape)}, the step "
                                 f"holds {dst.dtype} {tuple(dst.shape)} (another model?)")
        for key, dst in own.items():
            dst.copy_(state[key])


def make_train_step(model, compute_loss, solver_cfg: Dict, max_stepnum: int, epochs: int,
                    batch_size: int, warmup_stepnum: int, img_size: Tuple[int, int],
                    half: bool = True, device="cuda", compute_loss_ab=None,
                    teacher=None, grad_masks=None, quant=None) -> TrainStep:
    """The step of ``model`` (``build_model(..., deploy=False, device=device)``)
    under ``compute_loss`` (``losses/loss.py::ComputeLoss``), with the JAX
    ``make_train_step``'s arguments (its ``group_ids`` come from the model
    here). ``half`` runs the forward under bf16 autocast with fp32
    parameters; the loss is fp32. ``batch_size`` is the per-step batch that
    sets the accumulation (nominal 64). ``compute_loss_ab``
    (``losses/loss_fuseab.py::ComputeLossAB``, for a ``fuse_ab`` model) and
    ``teacher = (teacher_model, distill_loss)`` (``compute_loss`` is then
    unused, as in JAX) select the training recipes (see ``TrainStep``);
    ``grad_masks`` RepOpt's gradient masks; ``quant`` QAT's frozen ranges."""
    return TrainStep(model, compute_loss, solver_cfg, max_stepnum, epochs, batch_size,
                     warmup_stepnum, img_size, half=half, device=device,
                     compute_loss_ab=compute_loss_ab, teacher=teacher, grad_masks=grad_masks,
                     quant=quant)
