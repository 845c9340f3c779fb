"""Model size and cost (port of yolov6_tpu/utils/model_info.py; reference:
yolov6/utils/torch_utils.py:97-111, which profiles with thop).

``get_model_info(model, img_size)`` returns the JAX package's string,
``"Params: X.XXM, GFLOPs: Y.YY @ HxW"``. The FLOPs are counted by
``torch.utils.flop_counter.FlopCounterMode`` over one forward of a single
image, on the ``meta`` device, so that no arithmetic runs: 2 a multiply-add
of the convolutions and matrix products, nothing for the elementwise ops
(activations, additions, the decode). The JAX package reads XLA's cost
analysis of the compiled forward, which also counts the elementwise ops, so
its figure is somewhat larger. The model is copied to ``meta``; the
caller's model is left as it is.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_flops(model: torch.nn.Module, img_size: Tuple[int, int] = (640, 640)) -> int:
    """FLOPs of ``model``'s forward on one ``img_size`` (h, w) RGB image,
    counted on the ``meta`` device."""
    meta = model if next(model.parameters()).is_meta else copy.deepcopy(model).to("meta")
    was_training = meta.training
    meta.eval()
    x = torch.zeros((1, 3, img_size[0], img_size[1]), device="meta")
    try:
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            meta(x)
    finally:
        meta.train(was_training)
    return int(counter.get_total_flops())


def get_model_info(model: torch.nn.Module, img_size: Tuple[int, int] = (640, 640)) -> str:
    """``"Params: X.XXM, GFLOPs: Y.YY @ HxW"`` for a single-image forward."""
    flops = count_flops(model, img_size)
    return (f"Params: {count_params(model) / 1e6:.2f}M, GFLOPs: {flops / 1e9:.2f} @ "
            f"{img_size[0]}x{img_size[1]}")
