"""BiFPAN neck (port of yolov6_tpu/models/reppan.py::RepBiFPANNeck)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from yolov6_tpu_torch.layers.common import BiFusion, ConvBNReLU, RepBlock, RepVGGBlock
from yolov6_tpu_torch.utils.registry import NECKS


@NECKS.register()
class RepBiFPANNeck(nn.Module):
    """BiFusion PAN over 4 backbone levels (JAX: reppan.py:95-128, :225).

    Takes the backbone's ``(x3, x2, x1, x0)`` (P2..P5) and returns
    ``[pan_out2, pan_out1, pan_out0]`` (P3..P5)."""

    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 block=RepVGGBlock):
        super().__init__()
        ch, nr = channels_list, num_repeats
        self.reduce_layer0 = ConvBNReLU(ch[4], ch[5], 1, 1)
        self.Bifusion0 = BiFusion((ch[3], ch[2]), ch[5])
        self.Rep_p4 = RepBlock(ch[5], ch[5], nr[5], block)
        self.reduce_layer1 = ConvBNReLU(ch[5], ch[6], 1, 1)
        self.Bifusion1 = BiFusion((ch[2], ch[1]), ch[6])
        self.Rep_p3 = RepBlock(ch[6], ch[6], nr[6], block)
        self.downsample2 = ConvBNReLU(ch[6], ch[7], 3, 2)
        self.Rep_n3 = RepBlock(ch[7] + ch[6], ch[8], nr[7], block)
        self.downsample1 = ConvBNReLU(ch[8], ch[9], 3, 2)
        self.Rep_n4 = RepBlock(ch[9] + ch[5], ch[10], nr[8], block)

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
