"""BiFPAN necks (port of yolov6_tpu/models/reppan.py::RepBiFPANNeck,
CSPRepBiFPANNeck): one class body, whose stage block is a RepBlock or, in the
CSP neck, a BepC3."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from yolov6_tpu_torch.layers.common import BiFusion, ConvBNReLU, RepVGGBlock, stage_factory
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
    """The BiFPAN neck of M/L (JAX: reppan.py:229): BepC3 stages."""

    csp = True
