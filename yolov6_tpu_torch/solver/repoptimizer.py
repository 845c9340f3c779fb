"""RepOptimizer: gradient re-parameterization for RepOpt training (port of
yolov6_tpu/solver/repoptimizer.py).

RepOpt trains in two stages:

1. the hyper-search: the graph of ``LinearAddBlock``s (``training_mode =
   "hyper_search"``) learns each block's per-channel branch scales;
2. the RepOpt stage: the graph of plain ``RealVGGBlock``s (``"repopt"``),
   whose 3x3 convs start as the folded CSLA blocks of those scales
   (``reinitialize``) and train with SGD on gradients multiplied by masks
   made from them (``generate_gradient_masks``: ``s_conv²`` on every tap,
   plus ``s_1x1²`` on the centre tap and, with the identity branch, 1 on the
   centre tap's diagonal), which the train step applies before its SGD
   update (core/train_step.py).

Both graphs name their blocks alike, so the scales are keyed by the block's
module name (``"backbone.ERBlock_2.0"``), and the blocks are found by their
class: the JAX package's shape heuristic is not needed.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from yolov6_tpu_torch.layers.common import RealVGGBlock
from yolov6_tpu_torch.layers.reparam import linearadd_fold

Scales = Dict[str, Tuple[np.ndarray, ...]]


def extract_scales(state_dict: Mapping[str, torch.Tensor]) -> Scales:
    """A hyper-search graph's state dict -> ``{block name: (s_id, s_1x1,
    s_conv)}``, or ``(s_1x1, s_conv)`` for a block without the identity
    branch, float32 numpy (JAX: repoptimizer.py:52-66)."""
    scales = {}
    for key in state_dict:
        if not key.endswith("scale_conv.weight"):
            continue
        prefix = key[: -len("scale_conv.weight")]

        def scale(name):
            return state_dict[f"{prefix}{name}.weight"].detach().cpu().float().numpy()

        sc = (scale("scale_1x1"), scale("scale_conv"))
        if f"{prefix}scale_identity.weight" in state_dict:
            sc = (scale("scale_identity"),) + sc
        scales[prefix.rstrip(".")] = sc
    return scales


def find_repopt_blocks(model: nn.Module) -> Dict[str, RealVGGBlock]:
    """The RealVGGBlocks of a RepOpt-mode graph, by module name."""
    return {name: m for name, m in model.named_modules() if isinstance(m, RealVGGBlock)}


def _scales_of(scales: Scales, name: str):
    if name not in scales:
        raise KeyError(f"no CSLA scales for the block {name}")
    sc = scales[name]
    return (None,) + tuple(sc) if len(sc) == 2 else tuple(sc)


@torch.no_grad()
def reinitialize(model: nn.Module, scales: Scales,
                 kernels_1x1: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """Re-initialise each RealVGGBlock's 3x3 conv in place as the folded
    CSLA block (JAX: repoptimizer.py:74-114, with its default
    ``use_identity_scales``): its own kernel times ``s_conv``, plus a 1x1
    kernel times ``s_1x1`` on the centre tap, plus, with the identity
    branch, the identity times ``s_id``. The 1x1 kernel is drawn from U(-1/sqrt(cin),
    1/sqrt(cin)) by a torch generator of seed 0, the JAX package's
    distribution with other bits; ``kernels_1x1`` (block name ->
    (cout, cin, 1, 1)) gives them instead."""
    generator = torch.Generator().manual_seed(0)
    for name, block in find_repopt_blocks(model).items():
        s_id, s_1x1, s_conv = _scales_of(scales, name)
        w = block.conv.weight
        cout, cin = w.shape[:2]
        if kernels_1x1 is not None:
            k1 = kernels_1x1[name]
        else:
            bound = 1.0 / float(np.sqrt(cin))
            k1 = torch.rand((cout, cin, 1, 1), generator=generator) * (2 * bound) - bound
        if s_id is not None and cin != cout:
            raise ValueError(f"{name}: identity scales for a {cin} -> {cout} block")
        new = linearadd_fold(w.detach().cpu().numpy(), s_conv, np.asarray(k1, np.float32),
                             s_1x1, s_id, cout)
        w.copy_(torch.from_numpy(new).to(w.device, w.dtype))


def generate_gradient_masks(model: nn.Module, scales: Scales) -> Dict[str, torch.Tensor]:
    """Parameter name -> gradient mask of each RealVGGBlock's conv weight
    (JAX: repoptimizer.py:117-145), float32 on the CPU; every other
    parameter's mask is 1 and is left out."""
    masks = {}
    for name, block in find_repopt_blocks(model).items():
        s_id, s_1x1, s_conv = _scales_of(scales, name)
        cout, cin = block.conv.weight.shape[:2]
        mask = np.ones((cout, cin, 3, 3), np.float32) * (s_conv ** 2).reshape(-1, 1, 1, 1)
        mask[:, :, 1, 1] += (s_1x1 ** 2).reshape(-1, 1)
        if s_id is not None:
            ids = np.arange(cout)
            mask[ids, ids, 1, 1] += 1.0
        masks[f"{name}.conv.weight"] = torch.from_numpy(mask)
    return masks


def apply_gradient_masks(model: nn.Module, masks: Mapping[str, torch.Tensor]) -> None:
    """Multiply each masked parameter's gradient by its mask, in place (the
    train step does the same on its flat gradient buffer)."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, mask in masks.items():
            params[name].grad.mul_(mask.to(params[name].grad))
