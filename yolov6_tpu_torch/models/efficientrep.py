"""Backbones (port of yolov6_tpu/models/efficientrep.py::EfficientRep,
EfficientRep6, CSPBepBackbone, CSPBepBackbone_P6): one class body, whose
stage block is a RepBlock or, in the CSP backbones, a BepC3 or an MBLABlock,
over four stride-2 stages after the stem (P5) or five (P6); and the lite
family's shuffle backbone (``Lite_EffiBackbone``)."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from yolov6_tpu_torch.layers.common import (
    ConvBNHS, ConvBNSiLU, Lite_EffiBlockS1, Lite_EffiBlockS2, RepVGGBlock, sppf_cls,
    stage_factory,
)
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


@BACKBONES.register()
class Lite_EffiBackbone(nn.Module):
    """The lite family's shuffle backbone (JAX: efficientrep.py:183-214): a
    3x3 stride-2 stem ``conv_0`` of 24 channels whatever ``out_channels[0]``
    says (the reference hard-codes it), then four stages
    ``lite_effiblock_{1..4}``, each a stride-2 ``Lite_EffiBlockS2`` and
    ``num_repeat[stage] - 1`` stride-1 ``Lite_EffiBlockS1``s, stage ``s`` at
    width ``out_channels[s]`` with mid width ``mid_channels[s]``. Returns the
    last three stages' maps (strides 8, 16, 32)."""

    def __init__(self, in_channels: int, mid_channels: Sequence[int],
                 out_channels: Sequence[int], num_repeat: Sequence[int] = (1, 3, 7, 3),
                 deploy: bool = True):
        super().__init__()
        out_ch = [24] + list(out_channels[1:])
        self.conv_0 = ConvBNHS(in_channels, out_ch[0], 3, 2, deploy=deploy)
        for stage in range(1, 5):
            blocks = [Lite_EffiBlockS2(out_ch[stage - 1], mid_channels[stage], out_ch[stage], 2,
                                       deploy=deploy)]
            blocks += [Lite_EffiBlockS1(out_ch[stage], mid_channels[stage], out_ch[stage], 1,
                                        deploy=deploy)
                       for _ in range(num_repeat[stage - 1] - 1)]
            setattr(self, f"lite_effiblock_{stage}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.conv_0(x)
        outputs = []
        for stage in range(1, 5):
            x = getattr(self, f"lite_effiblock_{stage}")(x)
            if stage >= 2:
                outputs.append(x)
        return tuple(outputs)
