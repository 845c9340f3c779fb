"""The quant state of a model: which convs quantise their input, their
calibrated ranges, and the mode (port of the JAX package's ``QConv``,
yolov6_tpu/layers/common.py:33-64, and its global ``quant_state``).

The JAX package bakes a global flag into the traced graph; here the state
is an explicit object, a ``quant_mode``, that hooks the model's convs while it
is installed and leaves no trace when removed: no hook, no buffer, no
``state_dict()`` key. Every ``nn.Conv2d`` of the port is a ``QConv`` in the
JAX package (the ``Transpose`` block's ``ConvTranspose2d`` is not), so the
convs quantised, their order and their keys are the JAX ``quant``
collection's. Ranges are keyed by the JAX module path
(``fake_quant.jax_path``), so skip patterns, plain substrings of that path,
select the same convs in both packages; the configs' dotted
``sensitive_layers_list`` entries (``'detect.stems.0.conv'``) match no path
in either, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from yolov6_tpu_torch.quant.fake_quant import fake_quant, jax_path


def quant_paths(model: nn.Module) -> Dict[str, str]:
    """``{torch module name: JAX path}`` of every conv whose input the JAX
    package quantises (every ``nn.Conv2d``), in module order."""
    return {name: jax_path(name) for name, mod in model.named_modules()
            if isinstance(mod, nn.Conv2d)}


class quant_mode:  # noqa: N801  (a context manager, as ``torch.no_grad``)
    """Quantisation of ``model``'s conv inputs, installed at construction as
    forward pre-hooks on the convs whose JAX path holds none of
    ``skip_patterns``; ``remove()`` (or leaving the ``with`` block) takes
    them off. ``amax`` maps a JAX path to its range (a scalar), kept as
    fp32 0-d tensors on the model's device in ``self.amax``.

    - ``calibrating``: each hooked conv raises its range to ``max |input|``
      (fp32) and runs on the unquantised input (JAX: common.py:50-55);
      ranges start at ``amax``'s, else 0.
    - otherwise the conv's input goes through ``fake_quant`` with the frozen
      range, which every hooked conv must have (``KeyError``). The
      weights are not re-quantised here (``fake_quant.quantize_conv_weights``
      is the PTQ weight step).

    ``quant_mode(model)`` with neither ``amax`` nor ``calibrating`` is the
    disabled mode: it installs nothing. Use it as a context manager (as
    ``torch.no_grad``) or call ``remove()``."""

    def __init__(self, model: nn.Module, amax: Optional[Mapping[str, object]] = None,
                 calibrating: bool = False, num_bits: int = 8,
                 skip_patterns: Sequence[str] = ()):
        self.calibrating, self.num_bits = calibrating, num_bits
        param = next(model.parameters(), None)
        device = param.device if param is not None else torch.device("cpu")
        self.amax: Dict[str, torch.Tensor] = {
            k: torch.as_tensor(v).detach().to(device=device, dtype=torch.float32).reshape(())
            for k, v in (amax or {}).items()}
        self.paths = {} if amax is None and not calibrating else {
            name: path for name, path in quant_paths(model).items()
            if not any(p in path for p in skip_patterns)}
        missing = [p for p in self.paths.values() if p not in self.amax]
        if missing and not calibrating:
            raise KeyError(f"no calibrated range for {len(missing)} convs, e.g. {missing[:3]}")
        for path in missing:
            self.amax[path] = torch.zeros((), dtype=torch.float32, device=device)
        modules = dict(model.named_modules())
        self._handles = [modules[name].register_forward_pre_hook(self._hook(path))
                         for name, path in self.paths.items()]

    def _hook(self, path: str):
        if self.calibrating:
            def record(_, args):
                x = args[0].detach()
                self.amax[path] = torch.maximum(self.amax[path], x.abs().amax().float())
            return record

        def quantise(_, args):
            return (fake_quant(args[0], self.amax[path], self.num_bits),) + tuple(args[1:])
        return quantise

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def __enter__(self) -> "quant_mode":
        return self

    def __exit__(self, *exc) -> None:
        self.remove()
