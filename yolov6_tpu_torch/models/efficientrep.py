"""P5 backbones (port of yolov6_tpu/models/efficientrep.py::EfficientRep,
CSPBepBackbone): one class body, whose stage block is a RepBlock or, in the
CSP backbone, a BepC3."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from yolov6_tpu_torch.layers.common import RepVGGBlock, sppf_cls, stage_factory
from yolov6_tpu_torch.utils.registry import BACKBONES


@BACKBONES.register()
class EfficientRep(nn.Module):
    """P5 rep-style backbone (JAX: efficientrep.py:39-72).

    ``ERBlock_{2..5}`` are ``nn.Sequential``s so their parts are ``.0``
    (stride-2 rep block), ``.1`` (the stage block) and, in stage 5, ``.2``
    (the SPPF variant ``sppf_cls`` picks). Returns the pyramid as a tuple,
    lowest resolution last. ``csp_e`` and ``stage_block_type`` are read only
    by the CSP subclass."""

    csp = False

    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 block=RepVGGBlock, fuse_P2: bool = False, cspsppf: bool = False,
                 csp_e: float = 0.5, stage_block_type: str = "BepC3", in_channels: int = 3,
                 deploy: bool = True):
        super().__init__()
        ch, nr = channels_list, num_repeats
        stage = stage_factory(self.csp, block, csp_e, stage_block_type, deploy)
        self.fuse_P2 = fuse_P2
        self.stem = block(in_channels, ch[0], 3, 2, deploy=deploy)
        for i in (1, 2, 3, 4):
            parts = [block(ch[i - 1], ch[i], 3, 2, deploy=deploy), stage(ch[i], ch[i], nr[i])]
            if i == 4:
                parts.append(sppf_cls(block, cspsppf)(ch[4], ch[4], deploy=deploy))
            setattr(self, f"ERBlock_{i + 1}", nn.Sequential(*parts))

    def forward(self, x):
        outputs = []
        x = self.stem(x)
        for i in (1, 2, 3, 4):
            x = getattr(self, f"ERBlock_{i + 1}")(x)
            if (i == 1 and self.fuse_P2) or i >= 2:
                outputs.append(x)
        return tuple(outputs)


@BACKBONES.register()
class CSPBepBackbone(EfficientRep):
    """CSP backbone of M/L (JAX: efficientrep.py:106-144): BepC3 stages of
    hidden width ``int(out * csp_e)``."""

    csp = True
