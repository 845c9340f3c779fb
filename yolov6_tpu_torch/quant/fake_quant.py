"""INT8 fake quantisation (port of yolov6_tpu/quant/fake_quant.py).

Symmetric per-tensor quantisation of a conv's input with a calibrated
``amax``, per-output-channel quantisation of the conv weights, and a
straight-through round for QAT. The arithmetic is the JAX package's, step
for step, so that the fp32 results are bit-equal: ``x / scale`` stays a
division, the round is half to even (``torch.round``, as ``jnp.round``), and
the clip is a maximum then a minimum, whose gradient is split at a tie as
``jnp.clip``'s is. Plain torch ops, as the JAX package's are XLA ops: there
is no TPU kernel here to port.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch
from torch import nn


class _RoundSTE(torch.autograd.Function):
    """``torch.round`` whose gradient passes straight through (JAX:
    fake_quant.py:47-61, a ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _qrange(num_bits: int) -> float:
    return 2.0 ** (num_bits - 1) - 1


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``max(amax, 1e-12) / qmax`` as a true division: CUDA divides by a
    Python scalar as a multiply by its reciprocal, one bit off the CPU's
    and JAX's quotient, so ``qmax`` goes to the device as a tensor."""
    return torch.clamp_min(amax, 1e-12) / torch.full((), qmax, dtype=amax.dtype,
                                                      device=amax.device)


def _clip(v: torch.Tensor, qmax: float) -> torch.Tensor:
    """``jnp.clip(v, -qmax - 1, qmax)``: maximum, then minimum."""
    lo = torch.full((), -qmax - 1, dtype=v.dtype, device=v.device)
    hi = torch.full((), qmax, dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(v, lo), hi)


def fake_quant(x: torch.Tensor, amax, num_bits: int = 8) -> torch.Tensor:
    """Symmetric per-tensor fake quantisation with a straight-through
    gradient (JAX: fake_quant.py:64-71): ``round(clip(x / scale)) * scale``
    with ``scale = max(amax, 1e-12) / qmax``; where ``amax <= 0`` it returns
    ``x``. A bf16 or fp16 ``x`` is quantised in fp32 (as JAX promotes it
    against the fp32 ``amax``) and returned in its own dtype; a float64
    ``x`` in float64."""
    qmax = _qrange(num_bits)
    cdt = torch.promote_types(x.dtype, torch.float32)
    amax = torch.as_tensor(amax).to(device=x.device, dtype=cdt)
    scale = _scale(amax, qmax)
    q = _RoundSTE.apply(_clip(x.to(cdt) / scale, qmax)) * scale
    return torch.where(amax > 0, q.to(x.dtype), x)


def fake_quant_per_channel(w: torch.Tensor, num_bits: int = 8, axis: int = 0) -> torch.Tensor:
    """Per-channel symmetric fake quantisation of a weight along ``axis``
    (JAX: fake_quant.py:74-80, in ``w``'s dtype): 0 for a ``Conv2d`` (OIHW),
    1 for a ``ConvTranspose2d`` (in, out, kh, kw)."""
    qmax = _qrange(num_bits)
    axis = axis % w.dim()
    amax = w.abs().amax(dim=tuple(i for i in range(w.dim()) if i != axis), keepdim=True)
    scale = _scale(amax, qmax)
    return (_RoundSTE.apply(_clip(w / scale, qmax)) * scale).to(w.dtype)


def jax_path(name: str) -> str:
    """A torch module name as the JAX package's flax module path: an index
    of a ``ModuleList``/``Sequential`` joins its parent with ``.``, every
    other level with ``/`` (``detect.stems.0.block.conv`` ->
    ``detect/stems.0/block/conv``)."""
    parts = []
    for seg in name.split("."):
        if seg.isdigit() and parts:
            parts[-1] += "." + seg
        else:
            parts.append(seg)
    return "/".join(parts)


def conv_weight_paths(graph: nn.Module) -> Dict[str, Tuple[str, int]]:
    """``{state-dict key of a conv weight: (its JAX kernel path, its output
    axis)}`` for every conv of ``graph``: a ``Conv2d``'s along axis 0; a
    ``Transpose`` block's ``ConvTranspose2d`` along axis 1, under the block's
    own path (JAX keeps the kernel on the block)."""
    out = {}
    for name, mod in graph.named_modules():
        if isinstance(mod, nn.Conv2d):
            out[f"{name}.weight"] = (f"{jax_path(name)}/kernel", 0)
        elif isinstance(mod, nn.ConvTranspose2d):
            block = name.rsplit(".", 1)[0] if name.endswith(".upsample_transpose") else name
            out[f"{name}.weight"] = (f"{jax_path(block)}/kernel", 1)
    return out


def quantize_conv_weights(state_dict: Mapping[str, torch.Tensor], num_bits: int = 8,
                          skip_patterns: Sequence[str] = (), graph: nn.Module = None
                          ) -> Dict[str, torch.Tensor]:
    """The PTQ weight step (JAX: fake_quant.py:83-98 ``quantize_conv_params``):
    a copy of ``state_dict`` (``graph``'s) with every conv weight
    fake-quantised per output channel, except those whose JAX kernel path
    holds one of ``skip_patterns`` as a substring. A 4-D tensor that is no
    conv weight of ``graph`` raises ``ValueError``."""
    paths = conv_weight_paths(graph)
    stray = sorted(k for k, v in state_dict.items() if v.dim() == 4 and k not in paths)
    if stray:
        raise ValueError(f"4-D tensors that are no conv weight of the graph: {stray[:5]}")
    out = {}
    for key, value in state_dict.items():
        if key in paths and not any(p in paths[key][0] for p in skip_patterns):
            value = fake_quant_per_channel(value, num_bits, paths[key][1])
        out[key] = value
    return out
