"""Deploy-form blocks of the YOLOv6 P5 rep graph, as torch ``nn.Module``s (NCHW).

Port of yolov6_tpu/layers/common.py. Attribute names are the flax module
names, which are the upstream torch names, so state-dict keys line up with
the JAX parameter paths (utils/weights.py). Only the deploy forms exist
here: each conv carries its folded BN as a bias. The train-form branches,
BatchNorm and the other block families are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {"relu": F.relu, "silu": F.silu}


class ConvModule(nn.Module):
    """Conv (BN folded into its bias, same padding) + activation
    (JAX: common.py:177-216)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, act: str = "relu"):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              kernel_size // 2, bias=True)
        self.act = ACTIVATIONS[act]

    def forward(self, x):
        return self.act(self.conv(x))


def _conv_bn_act(act, name):
    """ConvBN{ReLU,SiLU} wrappers; the inner module is named ``block`` as in
    the reference wrappers (JAX: common.py:219-256)."""

    class _Wrapper(nn.Module):
        def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                     stride: int = 1):
            super().__init__()
            self.block = ConvModule(in_channels, out_channels, kernel_size, stride, act)

        def forward(self, x):
            return self.block(x)

    _Wrapper.__name__ = _Wrapper.__qualname__ = name
    return _Wrapper


ConvBNReLU = _conv_bn_act("relu", "ConvBNReLU")
ConvBNSiLU = _conv_bn_act("silu", "ConvBNSiLU")


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 same-padded max pool."""
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


class CSPSPPFModule(nn.Module):
    """CSP-wrapped SPPF with 5x5 pools and ReLU blocks, hidden width
    ``out_channels // 2`` (JAX: common.py:313-339)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c_ = out_channels // 2
        block = ConvBNReLU
        self.cv1 = block(in_channels, c_, 1, 1)
        self.cv2 = block(in_channels, c_, 1, 1)
        self.cv3 = block(c_, c_, 3, 1)
        self.cv4 = block(c_, c_, 1, 1)
        self.cv5 = block(4 * c_, c_, 1, 1)
        self.cv6 = block(c_, c_, 3, 1)
        self.cv7 = block(2 * c_, out_channels, 1, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y0 = self.cv2(x)
        y1 = max_pool_same(x1, 5)
        y2 = max_pool_same(y1, 5)
        y3 = max_pool_same(y2, 5)
        y3 = self.cv6(self.cv5(torch.cat([x1, y1, y2, y3], 1)))
        return self.cv7(torch.cat([y0, y3], 1))


class SimCSPSPPF(nn.Module):
    """CSPSPPF with ReLU (JAX: common.py:342-354)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.cspsppf = CSPSPPFModule(in_channels, out_channels)

    def forward(self, x):
        return self.cspsppf(x)


class Transpose(nn.Module):
    """2x upsampling by a 2x2 stride-2 transposed conv (JAX: common.py:372-403,
    which computes the same map as a matmul + depth-to-space)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upsample_transpose = nn.ConvTranspose2d(in_channels, out_channels, 2, 2, bias=True)

    def forward(self, x):
        return self.upsample_transpose(x)


class RepVGGBlock(nn.Module):
    """RepVGG block in its deploy form: one 3x3 conv + bias, then ReLU
    (JAX: common.py:406-438)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        if kernel_size != 3:
            raise ValueError("RepVGGBlock is 3x3")
        self.rbr_reparam = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=True)

    def forward(self, x):
        return F.relu(self.rbr_reparam(x))


class RepBlock(nn.Module):
    """Stage block: n sequential rep blocks (JAX: common.py:744-773)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 block=RepVGGBlock):
        super().__init__()
        self.conv1 = block(in_channels, out_channels)
        self.block = nn.ModuleList(block(out_channels, out_channels) for _ in range(n - 1))

    def forward(self, x):
        x = self.conv1(x)
        for b in self.block:
            x = b(x)
        return x


class BiFusion(nn.Module):
    """3-input fusion of the BiFPAN necks (JAX: common.py:845-864).

    ``x = [top, lateral, lower]``: upsample the top, 1x1 the lateral,
    1x1 and downsample the lower, concat, 1x1. ``in_channels`` are the
    lateral's and the lower's channels; the top has ``out_channels``."""

    def __init__(self, in_channels: Sequence[int], out_channels: int):
        super().__init__()
        self.upsample = Transpose(out_channels, out_channels)
        self.cv1 = ConvBNReLU(in_channels[0], out_channels, 1, 1)
        self.cv2 = ConvBNReLU(in_channels[1], out_channels, 1, 1)
        self.downsample = ConvBNReLU(out_channels, out_channels, 3, 2)
        self.cv3 = ConvBNReLU(3 * out_channels, out_channels, 1, 1)

    def forward(self, x: Sequence[torch.Tensor]):
        x0 = self.upsample(x[0])
        x1 = self.cv1(x[1])
        x2 = self.downsample(self.cv2(x[2]))
        return self.cv3(torch.cat([x0, x1, x2], 1))


def get_block(mode: str):
    """training_mode string -> block class (JAX: common.py:1014-1027)."""
    table = {"repvgg": RepVGGBlock}
    if mode not in table:
        raise NotImplementedError(f"rep-block mode {mode!r} is not ported yet")
    return table[mode]
