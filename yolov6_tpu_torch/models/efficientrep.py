"""P5 rep backbone (port of yolov6_tpu/models/efficientrep.py::EfficientRep)."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from yolov6_tpu_torch.layers.common import RepBlock, RepVGGBlock, SimCSPSPPF
from yolov6_tpu_torch.utils.registry import BACKBONES


@BACKBONES.register()
class EfficientRep(nn.Module):
    """P5 rep-style backbone (JAX: efficientrep.py:39-72).

    ``ERBlock_{2..5}`` are ``nn.Sequential``s so their parts are ``.0``
    (stride-2 rep block), ``.1`` (RepBlock) and, in stage 5, ``.2`` (SPPF).
    Returns the pyramid as a tuple, lowest resolution last."""

    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 block=RepVGGBlock, fuse_P2: bool = False, cspsppf: bool = False,
                 in_channels: int = 3):
        super().__init__()
        if not cspsppf or block is not RepVGGBlock:
            raise NotImplementedError("only the RepVGG backbone with cspsppf is ported")
        ch, nr = channels_list, num_repeats
        self.fuse_P2 = fuse_P2
        self.stem = block(in_channels, ch[0], 3, 2)
        for i in (1, 2, 3, 4):
            parts = [block(ch[i - 1], ch[i], 3, 2), RepBlock(ch[i], ch[i], n=nr[i], block=block)]
            if i == 4:
                parts.append(SimCSPSPPF(ch[4], ch[4]))
            setattr(self, f"ERBlock_{i + 1}", nn.Sequential(*parts))

    def forward(self, x):
        outputs = []
        x = self.stem(x)
        for i in (1, 2, 3, 4):
            x = getattr(self, f"ERBlock_{i + 1}")(x)
            if (i == 1 and self.fuse_P2) or i >= 2:
                outputs.append(x)
        return tuple(outputs)
