"""Backbones (port of yolov6_tpu/models/efficientrep.py::EfficientRep,
EfficientRep6, CSPBepBackbone, CSPBepBackbone_P6): one class body, whose
stage block is a RepBlock or, in the CSP backbones, a BepC3 or an MBLABlock,
over four stride-2 stages after the stem (P5) or five (P6)."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from yolov6_tpu_torch.layers.common import ConvBNSiLU, RepVGGBlock, sppf_cls, stage_factory
from yolov6_tpu_torch.utils.registry import BACKBONES


@BACKBONES.register()
class EfficientRep(nn.Module):
    """P5 rep-style backbone (JAX: efficientrep.py:39-72).

    ``ERBlock_{2..5}`` are ``nn.Sequential``s so their parts are ``.0``
    (stride-2 rep block), ``.1`` (the stage block) and, in the last stage,
    ``.2`` (the SPPF variant ``sppf_cls`` picks: SiLU after ``ConvBNSiLU``
    blocks). Returns the pyramid as a tuple, lowest resolution last, the
    first stage's output (P2) only with ``fuse_P2``. ``csp_e`` and
    ``stage_block_type`` are read only by the CSP subclasses."""

    csp = False
    n_stages = 4  # stride-2 stages after the stem
    relu_sppf = False  # the last stage's SPPF is a ReLU variant whatever the block
    always_p2 = False  # emit P2 whatever fuse_P2 says

    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 block=RepVGGBlock, fuse_P2: bool = False, cspsppf: bool = False,
                 csp_e: float = 0.5, stage_block_type: str = "BepC3", in_channels: int = 3,
                 deploy: bool = True):
        super().__init__()
        ch, nr, last = channels_list, num_repeats, self.n_stages
        stage = stage_factory(self.csp, block, csp_e, stage_block_type, deploy)
        self.fuse_P2 = fuse_P2 or self.always_p2
        self.stem = block(in_channels, ch[0], 3, 2, deploy=deploy)
        for i in range(1, last + 1):
            parts = [block(ch[i - 1], ch[i], 3, 2, deploy=deploy), stage(ch[i], ch[i], nr[i])]
            if i == last:
                silu = block is ConvBNSiLU and not self.relu_sppf
                parts.append(sppf_cls(silu, cspsppf)(ch[i], ch[i], deploy=deploy))
            setattr(self, f"ERBlock_{i + 1}", nn.Sequential(*parts))

    def forward(self, x):
        outputs = []
        x = self.stem(x)
        for i in range(1, self.n_stages + 1):
            x = getattr(self, f"ERBlock_{i + 1}")(x)
            if (i == 1 and self.fuse_P2) or i >= 2:
                outputs.append(x)
        return tuple(outputs)


@BACKBONES.register()
class CSPBepBackbone(EfficientRep):
    """CSP backbone of M/L and the MBLA configs (JAX: efficientrep.py:106-144):
    BepC3 or MBLABlock stages of hidden width ``int(out * csp_e)``."""

    csp = True


@BACKBONES.register()
class EfficientRep6(EfficientRep):
    """P6 rep-style backbone of N6/S6 (JAX: efficientrep.py:76-104): a sixth
    stage (``ERBlock_6``, stride 64) carries the SPPF, which is SimSPPF or
    SimCSPSPPF whatever the block, as in the JAX package."""

    n_stages = 5
    relu_sppf = True


@BACKBONES.register()
class CSPBepBackbone_P6(EfficientRep):
    """CSP P6 backbone of M6/L6 (JAX: efficientrep.py:148-180). As in the JAX
    package and upstream, it emits all five levels, P2 included, whatever
    ``fuse_P2`` says; its SPPF follows the block as the P5 one does."""

    csp = True
    n_stages = 5
    always_p2 = True
