"""BiFPAN necks (port of yolov6_tpu/models/reppan.py::RepBiFPANNeck,
CSPRepBiFPANNeck, RepBiFPANNeck6, CSPRepBiFPANNeck_P6): one class body for
each level count, whose stage block is a RepBlock or, in the CSP necks, a
BepC3 or an MBLABlock; and the lite family's neck (``Lite_EffiNeck``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from yolov6_tpu_torch.layers.common import (
    BiFusion, ConvBNHS, ConvBNReLU, CSPBlock, DPBlock, RepVGGBlock, stage_factory,
)
from yolov6_tpu_torch.utils.registry import NECKS


@NECKS.register()
class RepBiFPANNeck(nn.Module):
    """BiFusion PAN over 4 backbone levels (JAX: reppan.py:95-128, :225).

    Takes the backbone's ``(x3, x2, x1, x0)`` (P2..P5) and returns
    ``[pan_out2, pan_out1, pan_out0]`` (P3..P5). ``csp_e`` and
    ``stage_block_type`` are read only by the CSP subclass."""

    csp = False

    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 block=RepVGGBlock, csp_e: float = 0.5, stage_block_type: str = "BepC3",
                 deploy: bool = True):
        super().__init__()
        ch, nr, d = channels_list, num_repeats, deploy
        stage = stage_factory(self.csp, block, csp_e, stage_block_type, deploy)
        self.reduce_layer0 = ConvBNReLU(ch[4], ch[5], 1, 1, deploy=d)
        self.Bifusion0 = BiFusion((ch[3], ch[2]), ch[5], deploy=d)
        self.Rep_p4 = stage(ch[5], ch[5], nr[5])
        self.reduce_layer1 = ConvBNReLU(ch[5], ch[6], 1, 1, deploy=d)
        self.Bifusion1 = BiFusion((ch[2], ch[1]), ch[6], deploy=d)
        self.Rep_p3 = stage(ch[6], ch[6], nr[6])
        self.downsample2 = ConvBNReLU(ch[6], ch[7], 3, 2, deploy=d)
        self.Rep_n3 = stage(ch[7] + ch[6], ch[8], nr[7])
        self.downsample1 = ConvBNReLU(ch[8], ch[9], 3, 2, deploy=d)
        self.Rep_n4 = stage(ch[9] + ch[5], ch[10], nr[8])

    def forward(self, inputs):
        x3, x2, x1, x0 = inputs
        fpn_out0 = self.reduce_layer0(x0)
        f_out0 = self.Rep_p4(self.Bifusion0([fpn_out0, x1, x2]))
        fpn_out1 = self.reduce_layer1(f_out0)
        pan_out2 = self.Rep_p3(self.Bifusion1([fpn_out1, x2, x3]))
        down1 = self.downsample2(pan_out2)
        pan_out1 = self.Rep_n3(torch.cat([down1, fpn_out1], 1))
        down0 = self.downsample1(pan_out1)
        pan_out0 = self.Rep_n4(torch.cat([down0, fpn_out0], 1))
        return [pan_out2, pan_out1, pan_out0]


@NECKS.register()
class CSPRepBiFPANNeck(RepBiFPANNeck):
    """The BiFPAN neck of M/L and the MBLA configs (JAX: reppan.py:229): BepC3
    or MBLABlock stages."""

    csp = True


@NECKS.register()
class RepBiFPANNeck6(nn.Module):
    """BiFusion PAN over 5 backbone levels (JAX: reppan.py:174-214, :241).

    Takes the backbone's ``(x4, x3, x2, x1, x0)`` (P2..P6) and returns
    ``[pan_out3, pan_out2, pan_out1, pan_out0]`` (P3..P6); the neck's
    widths are ``channels_list[6:12]``. ``csp_e`` and ``stage_block_type``
    are read only by the CSP subclass."""

    csp = False

    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 block=RepVGGBlock, csp_e: float = 0.5, stage_block_type: str = "BepC3",
                 deploy: bool = True):
        super().__init__()
        ch, nr, d = channels_list, num_repeats, deploy
        stage = stage_factory(self.csp, block, csp_e, stage_block_type, deploy)
        self.reduce_layer0 = ConvBNReLU(ch[5], ch[6], 1, 1, deploy=d)
        self.Bifusion0 = BiFusion((ch[4], ch[3]), ch[6], deploy=d)
        self.Rep_p5 = stage(ch[6], ch[6], nr[6])
        self.reduce_layer1 = ConvBNReLU(ch[6], ch[7], 1, 1, deploy=d)
        self.Bifusion1 = BiFusion((ch[3], ch[2]), ch[7], deploy=d)
        self.Rep_p4 = stage(ch[7], ch[7], nr[7])
        self.reduce_layer2 = ConvBNReLU(ch[7], ch[8], 1, 1, deploy=d)
        self.Bifusion2 = BiFusion((ch[2], ch[1]), ch[8], deploy=d)
        self.Rep_p3 = stage(ch[8], ch[8], nr[8])
        self.downsample2 = ConvBNReLU(ch[8], ch[8], 3, 2, deploy=d)
        self.Rep_n4 = stage(ch[8] + ch[8], ch[9], nr[9])
        self.downsample1 = ConvBNReLU(ch[9], ch[9], 3, 2, deploy=d)
        self.Rep_n5 = stage(ch[9] + ch[7], ch[10], nr[10])
        self.downsample0 = ConvBNReLU(ch[10], ch[10], 3, 2, deploy=d)
        self.Rep_n6 = stage(ch[10] + ch[6], ch[11], nr[11])

    def forward(self, inputs):
        x4, x3, x2, x1, x0 = inputs
        fpn_out0 = self.reduce_layer0(x0)
        f_out0 = self.Rep_p5(self.Bifusion0([fpn_out0, x1, x2]))
        fpn_out1 = self.reduce_layer1(f_out0)
        f_out1 = self.Rep_p4(self.Bifusion1([fpn_out1, x2, x3]))
        fpn_out2 = self.reduce_layer2(f_out1)
        pan_out3 = self.Rep_p3(self.Bifusion2([fpn_out2, x3, x4]))
        pan_out2 = self.Rep_n4(torch.cat([self.downsample2(pan_out3), fpn_out2], 1))
        pan_out1 = self.Rep_n5(torch.cat([self.downsample1(pan_out2), fpn_out1], 1))
        pan_out0 = self.Rep_n6(torch.cat([self.downsample0(pan_out1), fpn_out0], 1))
        return [pan_out3, pan_out2, pan_out1, pan_out0]


@NECKS.register()
class CSPRepBiFPANNeck_P6(RepBiFPANNeck6):
    """The BiFPAN neck of M6/L6 (JAX: reppan.py:245): BepC3 or MBLABlock
    stages."""

    csp = True


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling (JAX: reppan.py:31-33)."""
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


@NECKS.register()
class Lite_EffiNeck(nn.Module):
    """The lite family's PAN over the backbone's three levels (JAX:
    reppan.py:257-290): every level reduced to ``unified_channels`` by a 1x1
    conv, nearest 2x upsampling, lite ``CSPBlock``s with 5x5 depthwise convs,
    5x5 stride-2 ``DPBlock`` downsamples, and a stride-64 level
    ``p6_conv_1(fpn_out0) + p6_conv_2(pan_out1)``, both read from stride-32
    maps. Takes ``(x2, x1, x0)`` of widths ``in_channels`` and returns
    ``[pan_out3, pan_out2, pan_out1, pan_out0]`` (strides 8-64)."""

    def __init__(self, in_channels: Sequence[int], unified_channels: int, deploy: bool = True):
        super().__init__()
        uc, kw = unified_channels, dict(deploy=deploy)
        self.reduce_layer0 = ConvBNHS(in_channels[2], uc, 1, 1, **kw)
        self.reduce_layer1 = ConvBNHS(in_channels[1], uc, 1, 1, **kw)
        self.reduce_layer2 = ConvBNHS(in_channels[0], uc, 1, 1, **kw)
        self.Csp_p4 = CSPBlock(2 * uc, uc, 5, **kw)
        self.Csp_p3 = CSPBlock(2 * uc, uc, 5, **kw)
        self.downsample2 = DPBlock(uc, 5, 2, **kw)
        self.Csp_n3 = CSPBlock(2 * uc, uc, 5, **kw)
        self.downsample1 = DPBlock(uc, 5, 2, **kw)
        self.Csp_n4 = CSPBlock(2 * uc, uc, 5, **kw)
        self.p6_conv_1 = DPBlock(uc, 5, 2, **kw)
        self.p6_conv_2 = DPBlock(uc, 5, 2, **kw)

    def forward(self, inputs):
        x2, x1, x0 = inputs
        fpn_out0 = self.reduce_layer0(x0)
        x1 = self.reduce_layer1(x1)
        x2 = self.reduce_layer2(x2)
        f_out1 = self.Csp_p4(torch.cat([upsample_nearest2x(fpn_out0), x1], 1))
        pan_out3 = self.Csp_p3(torch.cat([upsample_nearest2x(f_out1), x2], 1))
        pan_out2 = self.Csp_n3(torch.cat([self.downsample2(pan_out3), f_out1], 1))
        pan_out1 = self.Csp_n4(torch.cat([self.downsample1(pan_out2), fpn_out0], 1))
        pan_out0 = self.p6_conv_1(fpn_out0) + self.p6_conv_2(pan_out1)
        return [pan_out3, pan_out2, pan_out1, pan_out0]
