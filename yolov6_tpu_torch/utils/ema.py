"""Exponential moving average of the model (port of yolov6_tpu/utils/ema.py:12-25):
decay ramps as 0.9999·(1 − exp(−updates/2000))."""

from __future__ import annotations

from typing import List, Sequence

import torch


def ema_decay(updates: torch.Tensor, decay: float = 0.9999, tau: float = 2000.0) -> torch.Tensor:
    return decay * (1 - torch.exp(-updates / tau))


def ema_update(ema: Sequence[torch.Tensor], model: Sequence[torch.Tensor], updates: torch.Tensor,
               decay: float = 0.9999) -> List[torch.Tensor]:
    """``ema·d + (1 − d)·model`` for float tensors, the model's value for the
    others (integer buffers), as new tensors."""
    d = ema_decay(updates, decay)
    return [e * d + (1.0 - d) * m.to(e.dtype) if e.is_floating_point() else m.clone()
            for e, m in zip(ema, model)]
