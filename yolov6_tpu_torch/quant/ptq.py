"""Post-training quantisation (port of yolov6_tpu/quant/ptq.py): activation
calibration, the weight step, and the per-layer sensitivity sweep.

1. ``calibrate`` runs batches through the model in eval mode with every
   hooked conv recording ``max |input|`` (the max method, the reference's
   default for convs); the ranges accumulate across batches.
2. ``quantize_variables`` fake-quantises the conv weights per channel.
3. Eval and serving under ``quant_mode(model, amax)`` fake-quantise each
   conv's input with its range.
Partial quantisation: ``skip_patterns`` keeps sensitive layers in float.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import torch
from torch import nn

from yolov6_tpu_torch.quant.fake_quant import quantize_conv_weights
from yolov6_tpu_torch.quant.state import quant_mode
from yolov6_tpu_torch.utils.events import LOGGER


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable, num_bits: int = 8,
              skip_patterns: Sequence[str] = (), max_batches: int = 32,
              amax: Optional[Mapping[str, object]] = None) -> Dict[str, torch.Tensor]:
    """The ranges of ``model``'s conv inputs over at most ``max_batches`` of
    ``batches`` (JAX: ptq.py:29-62), starting from ``amax`` if given.

    A batch is an image array ``[b, H, W, 3]`` (NHWC, as the loaders give
    them; uint8 or float) or a tuple whose first item is one; it goes to the
    model's device as fp32, divided by 255 when its max exceeds 2. The
    model runs in eval mode (its mode is restored after) in fp32. Returns
    ``{JAX path: fp32 0-d tensor}`` on the model's device."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with quant_mode(model, amax, calibrating=True, num_bits=num_bits,
                        skip_patterns=skip_patterns) as q:
            for bi, batch in enumerate(batches):
                if bi >= max_batches:
                    break
                imgs = batch[0] if isinstance(batch, (tuple, list)) else batch
                x = torch.as_tensor(imgs).to(device).float()
                if float(x.max()) > 2.0:
                    x = x / 255.0
                model(x.permute(0, 3, 1, 2).contiguous())
                LOGGER.info(f"calibration batch {bi + 1}")
    finally:
        model.train(was_training)
    return q.amax


def quantize_variables(state_dict: Mapping[str, torch.Tensor], graph: nn.Module,
                       num_bits: int = 8, skip_patterns: Sequence[str] = ()
                       ) -> Dict[str, torch.Tensor]:
    """The PTQ weight step (JAX: ptq.py:65-70): ``state_dict`` (of
    ``graph``) with its conv weights fake-quantised per output channel but
    for those matching ``skip_patterns``."""
    with torch.no_grad():
        return quantize_conv_weights(state_dict, num_bits, skip_patterns, graph)


def sensitivity_analyse(eval_fn, layer_paths: List[str], baseline_ap: float):
    """Per-layer quantisation sensitivity (JAX: ptq.py:73-81; reference
    tools/partial_quantization/sensitivity_analyse.py): each layer is
    quantised alone, every other path passed to ``eval_fn(skip_patterns) ->
    mAP`` as a skip. Returns ``[(drop, path)]``, most sensitive first."""
    results = []
    for path in layer_paths:
        others = [p for p in layer_paths if p != path]
        ap = eval_fn(others)
        results.append((baseline_ap - ap, path))
        LOGGER.info(f"sensitivity {path}: drop {baseline_ap - ap:.4f}")
    return sorted(results, reverse=True)
