"""Blocks of the YOLOv6 graphs, as torch ``nn.Module``s (NCHW).

Port of yolov6_tpu/layers/common.py. Attribute names are the flax module
names, which are the upstream torch names, so state-dict keys line up with
the JAX parameter paths (utils/weights.py). Every block takes ``deploy``:
``True`` (the default) builds the deploy form, each conv carrying its folded
BN as a bias; ``False`` builds the train form, conv without bias + BatchNorm,
RepVGGBlock's three branches and QARepVGG's two branches, skip and post-sum
BN. layers/reparam.py folds the second into the first. Ported: the blocks of
the EfficientRep/CSPBep graphs, P5 and P6 (N/S/M/L, N6/S6/M6/L6), the MBLA
stage, the QARepVGG blocks (V1 and V2), the lite family's blocks
(shuffle blocks, SE, depthwise-separable and lite CSP blocks) and RepOpt's
blocks (RealVGGBlock, ScaleLayer, LinearAddBlock).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {"relu": F.relu, "silu": F.silu, "hardswish": F.hardswish, None: lambda x: x}


def batch_norm(channels: int) -> nn.BatchNorm2d:
    """The reference's BN (utils/torch_utils.py:38-47: eps 1e-3, momentum
    0.03), which JAX ``TorchBatchNorm`` (common.py:112-155) copies with flax
    momentum 0.97: normalise by the biased batch variance, update
    ``running_var`` with the unbiased one."""
    return nn.BatchNorm2d(channels, eps=1e-3, momentum=0.03)


class ConvModule(nn.Module):
    """Conv (same padding, ``groups`` groups) + BN + activation (JAX:
    common.py:177-216). ``deploy``: BN folded into the conv's bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, act: str | None = "relu", deploy: bool = True,
                 groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, kernel_size // 2,
                              groups=groups, bias=deploy)
        self.bn = None if deploy else batch_norm(out_channels)
        self.act = ACTIVATIONS[act]

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


def _conv_bn_act(act, name):
    """ConvBN{ReLU,SiLU,HS} and ConvBN wrappers; the inner module is named
    ``block`` as in the reference wrappers (JAX: common.py:219-256)."""

    class _Wrapper(nn.Module):
        def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                     stride: int = 1, deploy: bool = True, groups: int = 1):
            super().__init__()
            self.block = ConvModule(in_channels, out_channels, kernel_size, stride, act,
                                    deploy=deploy, groups=groups)

        def forward(self, x):
            return self.block(x)

    _Wrapper.__name__ = _Wrapper.__qualname__ = name
    return _Wrapper


ConvBNReLU = _conv_bn_act("relu", "ConvBNReLU")
ConvBNSiLU = _conv_bn_act("silu", "ConvBNSiLU")
ConvBNHS = _conv_bn_act("hardswish", "ConvBNHS")
ConvBN = _conv_bn_act(None, "ConvBN")


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 same-padded max pool."""
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


class SPPFModule(nn.Module):
    """Serial 5x5 max-pool pyramid, hidden width ``in_channels // 2`` (JAX:
    common.py:265-282)."""

    def __init__(self, in_channels: int, out_channels: int, block=ConvBNReLU,
                 deploy: bool = True):
        super().__init__()
        c_ = in_channels // 2
        self.cv1 = block(in_channels, c_, 1, 1, deploy=deploy)
        self.cv2 = block(4 * c_, out_channels, 1, 1, deploy=deploy)

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool_same(x, 5)
        y2 = max_pool_same(y1, 5)
        y3 = max_pool_same(y2, 5)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class CSPSPPFModule(nn.Module):
    """CSP-wrapped SPPF with 5x5 pools, hidden width ``out_channels // 2``
    (JAX: common.py:313-339)."""

    def __init__(self, in_channels: int, out_channels: int, block=ConvBNReLU,
                 deploy: bool = True):
        super().__init__()
        c_ = out_channels // 2

        def conv(cin, cout, k):
            return block(cin, cout, k, 1, deploy=deploy)

        self.cv1 = conv(in_channels, c_, 1)
        self.cv2 = conv(in_channels, c_, 1)
        self.cv3 = conv(c_, c_, 3)
        self.cv4 = conv(c_, c_, 1)
        self.cv5 = conv(4 * c_, c_, 1)
        self.cv6 = conv(c_, c_, 3)
        self.cv7 = conv(2 * c_, out_channels, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y0 = self.cv2(x)
        y1 = max_pool_same(x1, 5)
        y2 = max_pool_same(y1, 5)
        y3 = max_pool_same(y2, 5)
        y3 = self.cv6(self.cv5(torch.cat([x1, y1, y2, y3], 1)))
        return self.cv7(torch.cat([y0, y3], 1))


class SimSPPF(nn.Module):
    """SPPF with ReLU (JAX: common.py:285-296)."""

    block = ConvBNReLU

    def __init__(self, in_channels: int, out_channels: int, deploy: bool = True):
        super().__init__()
        self.sppf = SPPFModule(in_channels, out_channels, self.block, deploy)

    def forward(self, x):
        return self.sppf(x)


class SPPF(SimSPPF):
    """SPPF with SiLU (JAX: common.py:299-310)."""

    block = ConvBNSiLU


class SimCSPSPPF(nn.Module):
    """CSPSPPF with ReLU (JAX: common.py:342-354)."""

    block = ConvBNReLU

    def __init__(self, in_channels: int, out_channels: int, deploy: bool = True):
        super().__init__()
        self.cspsppf = CSPSPPFModule(in_channels, out_channels, self.block, deploy)

    def forward(self, x):
        return self.cspsppf(x)


class CSPSPPF(SimCSPSPPF):
    """CSPSPPF with SiLU (JAX: common.py:358-369)."""

    block = ConvBNSiLU


def sppf_cls(silu: bool, cspsppf: bool):
    """The last stage's SPPF layer of the backbones (JAX: efficientrep.py:32-36):
    the SiLU variants when ``silu``, the ReLU ones otherwise."""
    if cspsppf:
        return CSPSPPF if silu else SimCSPSPPF
    return SPPF if silu else SimSPPF


class Transpose(nn.Module):
    """2x upsampling by a 2x2 stride-2 transposed conv (JAX: common.py:372-403,
    which computes the same map as a matmul + depth-to-space). The same in
    both forms: it has no BN."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upsample_transpose = nn.ConvTranspose2d(in_channels, out_channels, 2, 2, bias=True)

    def forward(self, x):
        return self.upsample_transpose(x)


class RepVGGBlock(nn.Module):
    """RepVGG block, then ReLU (JAX: common.py:406-454). Deploy form: one 3x3
    conv + bias (``rbr_reparam``). Train form: 3x3 conv+BN (``rbr_dense``) +
    1x1 conv+BN (``rbr_1x1``) + a BN of the input (``rbr_identity``, only when
    in == out and stride 1), summed."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, deploy: bool = True):
        super().__init__()
        if kernel_size != 3:
            raise ValueError("RepVGGBlock is 3x3")
        self.deploy = deploy
        if deploy:
            self.rbr_reparam = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=True)
            return
        self.rbr_dense = ConvModule(in_channels, out_channels, 3, stride, None, deploy=False)
        self.rbr_1x1 = ConvModule(in_channels, out_channels, 1, stride, None, deploy=False)
        self.rbr_identity = (batch_norm(in_channels)
                             if in_channels == out_channels and stride == 1 else None)

    def forward(self, x):
        if self.deploy:
            return F.relu(self.rbr_reparam(x))
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return F.relu(y)


class QARepVGGBlock(nn.Module):
    """Quantization-aware RepVGG block, then ReLU (JAX: common.py:502-554).
    Deploy form: ``rbr_reparam`` as RepVGGBlock's. Train form: the 3x3
    conv+BN ``rbr_dense`` + a bare 1x1 conv ``rbr_1x1`` + the input itself
    (only when in == out and stride 1), summed, then one BN ``bn``.
    ``has_identity`` and ``has_avg`` (V2's average branch) record that rule in
    both forms, for the fold (layers/reparam.py)."""

    avg_branch = False

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, deploy: bool = True):
        super().__init__()
        if kernel_size != 3:
            raise ValueError(f"{type(self).__name__} is 3x3")
        self.deploy = deploy
        self.has_identity = in_channels == out_channels and stride == 1
        self.has_avg = self.avg_branch and self.has_identity
        if deploy:
            self.rbr_reparam = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=True)
            return
        self.rbr_dense = ConvModule(in_channels, out_channels, 3, stride, None, deploy=False)
        self.rbr_1x1 = nn.Conv2d(in_channels, out_channels, 1, stride, 0, bias=False)
        self.bn = batch_norm(out_channels)

    def forward(self, x):
        if self.deploy:
            return F.relu(self.rbr_reparam(x))
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.has_identity:
            y = y + x
        if self.has_avg:
            y = y + F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)
        return F.relu(self.bn(y))


class QARepVGGBlockV2(QARepVGGBlock):
    """QARepVGG V2 (JAX: common.py:558-608): where the identity branch
    exists, a 3x3 stride-1 average pool of the input (zeros counted at the
    border) joins the sum."""

    avg_branch = True


class BottleRep(nn.Module):
    """``n_convs`` ``basic_block``s and a residual (JAX: common.py:697-717;
    BottleRep3, three of them: :721-742). With ``weight`` the residual is
    scaled by a learnable ``alpha`` of shape (1,), initialised to 1; the
    residual exists only when in == out."""

    n_convs = 2

    def __init__(self, in_channels: int, out_channels: int, basic_block=RepVGGBlock,
                 weight: bool = False, deploy: bool = True):
        super().__init__()
        for i in range(self.n_convs):
            setattr(self, f"conv{i + 1}",
                    basic_block(in_channels if i == 0 else out_channels, out_channels,
                                deploy=deploy))
        self.shortcut = in_channels == out_channels
        self.alpha = nn.Parameter(torch.ones(1)) if self.shortcut and weight else None

    def forward(self, x):
        y = x
        for i in range(self.n_convs):
            y = getattr(self, f"conv{i + 1}")(y)
        if not self.shortcut:
            return y
        return y + (x if self.alpha is None else self.alpha.to(x.dtype) * x)


class BottleRep3(BottleRep):
    """BottleRep of three ``basic_block``s, the MBLA block's unit (JAX:
    common.py:721-742)."""

    n_convs = 3


class RepBlock(nn.Module):
    """Stage block: n sequential rep blocks (JAX: common.py:744-773). With
    ``block=BottleRep`` it holds ``max(n // 2, 1)`` BottleReps of
    ``basic_block``, each with its ``alpha``."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 block=RepVGGBlock, basic_block=RepVGGBlock, deploy: bool = True):
        super().__init__()
        if block is BottleRep:
            def make(cin):
                return BottleRep(cin, out_channels, basic_block, weight=True, deploy=deploy)
            n_more = n // 2 - 1
        else:
            def make(cin):
                return block(cin, out_channels, deploy=deploy)
            n_more = n - 1
        self.conv1 = make(in_channels)
        self.block = nn.ModuleList(make(out_channels) for _ in range(n_more))

    def forward(self, x):
        x = self.conv1(x)
        for b in self.block:
            x = b(x)
        return x


class BepC3(nn.Module):
    """CSP stack of BottleReps (JAX: common.py:776-799): ``cv1`` -> ``m`` (a
    RepBlock of BottleReps of ``block``) beside ``cv2``, concatenated, then
    ``cv3``; hidden width ``int(out_channels * e)``. The 1x1 convs are
    ``ConvBNSiLU`` when ``block`` is, else ``ConvBNReLU``."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1, e: float = 0.5,
                 block=RepVGGBlock, deploy: bool = True):
        super().__init__()
        c_ = int(out_channels * e)
        wrapper = ConvBNSiLU if block is ConvBNSiLU else ConvBNReLU
        self.cv1 = wrapper(in_channels, c_, 1, 1, deploy=deploy)
        self.m = RepBlock(c_, c_, n, BottleRep, block, deploy=deploy)
        self.cv2 = wrapper(in_channels, c_, 1, 1, deploy=deploy)
        self.cv3 = wrapper(2 * c_, out_channels, 1, 1, deploy=deploy)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class MBLABlock(nn.Module):
    """Multi-branch layer aggregation (JAX: common.py:803-843): ``cv1`` writes
    ``len(n_list)`` chunks of the hidden width ``int(out_channels * e)``;
    chunk 0 passes as it is, and chunk ``k`` feeds a chain of ``n_list[k]``
    BottleRep3s (``m.{k-1}.{j}``, each with its ``alpha``) whose every output
    is kept; ``cv2`` merges the chunks and the chains' outputs. ``n_list`` is
    ``[0, 1]`` for ``n // 2 <= 1``, else ``[0, s, n // 2]`` with ``s`` the
    largest power of two below ``n // 2``. The 1x1 convs are ``ConvModule``s
    with SiLU when ``block`` is ``ConvBNSiLU``, else ReLU."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1, e: float = 0.5,
                 block=RepVGGBlock, deploy: bool = True):
        super().__init__()
        n = max(n // 2, 1)
        if n == 1:
            n_list = [0, 1]
        else:
            extra_branch_steps = 1
            while extra_branch_steps * 2 < n:
                extra_branch_steps *= 2
            n_list = [0, extra_branch_steps, n]
        self.c_ = c_ = int(out_channels * e)
        act = "silu" if block is ConvBNSiLU else "relu"
        self.cv1 = ConvModule(in_channels, len(n_list) * c_, 1, 1, act, deploy=deploy)
        self.m = nn.ModuleList(
            nn.ModuleList(BottleRep3(c_, c_, block, weight=True, deploy=deploy)
                          for _ in range(steps))
            for steps in n_list[1:])
        self.cv2 = ConvModule((len(n_list) + sum(n_list)) * c_, out_channels, 1, 1, act,
                              deploy=deploy)

    def forward(self, x):
        ys = torch.split(self.cv1(x), self.c_, 1)
        all_y = [ys[0]]
        for chunk, chain in zip(ys[1:], self.m):
            all_y.append(chunk)
            for unit in chain:
                all_y.append(unit(all_y[-1]))
        return self.cv2(torch.cat(all_y, 1))


def stage_factory(csp: bool, block, csp_e: float = 0.5, stage_block_type: str = "BepC3",
                  deploy: bool = True):
    """The stage block of the rep backbones and necks (JAX: reppan.py:36-56):
    ``RepBlock`` of ``block``, or with ``csp`` the CSP stage block
    (``BepC3`` or ``MBLABlock``) with its ``(n, e)``. Returns
    ``make(in_channels, out_channels, n)``."""
    stage_blocks = {"BepC3": BepC3, "MBLABlock": MBLABlock}
    if csp and stage_block_type not in stage_blocks:
        raise ValueError(f"unknown stage_block_type {stage_block_type!r}")

    def make(in_channels: int, out_channels: int, n: int) -> nn.Module:
        if csp:
            return stage_blocks[stage_block_type](in_channels, out_channels, n, csp_e, block,
                                                  deploy=deploy)
        return RepBlock(in_channels, out_channels, n, block, deploy=deploy)

    return make


class BiFusion(nn.Module):
    """3-input fusion of the BiFPAN necks (JAX: common.py:845-864).

    ``x = [top, lateral, lower]``: upsample the top, 1x1 the lateral,
    1x1 and downsample the lower, concat, 1x1. ``in_channels`` are the
    lateral's and the lower's channels; the top has ``out_channels``."""

    def __init__(self, in_channels: Sequence[int], out_channels: int, deploy: bool = True):
        super().__init__()
        self.upsample = Transpose(out_channels, out_channels)
        self.cv1 = ConvBNReLU(in_channels[0], out_channels, 1, 1, deploy=deploy)
        self.cv2 = ConvBNReLU(in_channels[1], out_channels, 1, 1, deploy=deploy)
        self.downsample = ConvBNReLU(out_channels, out_channels, 3, 2, deploy=deploy)
        self.cv3 = ConvBNReLU(3 * out_channels, out_channels, 1, 1, deploy=deploy)

    def forward(self, x: Sequence[torch.Tensor]):
        x0 = self.upsample(x[0])
        x1 = self.cv1(x[1])
        x2 = self.downsample(self.cv2(x[2]))
        return self.cv3(torch.cat([x0, x1, x2], 1))


class SEBlock(nn.Module):
    """Squeeze-and-excite (JAX: common.py:868-884): the spatial mean, a 1x1
    conv to ``channel // reduction``, ReLU, a 1x1 conv back, and a
    hard-sigmoid gate on the input. Both convs carry a bias, in both forms."""

    def __init__(self, channel: int, reduction: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(channel, channel // reduction, 1)
        self.conv2 = nn.Conv2d(channel // reduction, channel, 1)

    def forward(self, x):
        w = F.relu(self.conv1(x.mean((2, 3), keepdim=True)))
        return x * F.hardsigmoid(self.conv2(w))


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet channel shuffle, NCHW (JAX: common.py:887-892, NHWC):
    output channel ``j * groups + g`` is input channel ``g * (c // groups) + j``."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


class Lite_EffiBlockS1(nn.Module):
    """Stride-1 shuffle block (JAX: common.py:895-915): the input's second
    half goes 1x1 (hard-swish) -> 3x3 depthwise -> SE -> 1x1 (hard-swish),
    beside the first half, then a shuffle of two groups."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int, stride: int = 1,
                 deploy: bool = True):
        super().__init__()
        self.conv_pw_1 = ConvBNHS(in_channels // 2, mid_channels, 1, 1, deploy=deploy)
        self.conv_dw_1 = ConvBN(mid_channels, mid_channels, 3, stride, deploy=deploy,
                                groups=mid_channels)
        self.se = SEBlock(mid_channels)
        self.conv_1 = ConvBNHS(mid_channels, out_channels // 2, 1, 1, deploy=deploy)

    def forward(self, x):
        x1, x2 = torch.chunk(x, 2, 1)
        y = self.conv_1(self.se(self.conv_dw_1(self.conv_pw_1(x2))))
        return channel_shuffle(torch.cat([x1, y], 1), 2)


class Lite_EffiBlockS2(nn.Module):
    """Stride-2 two-branch block (JAX: common.py:917-940): a 3x3 depthwise
    then 1x1 branch beside a 1x1 -> 3x3 depthwise -> SE -> 1x1 branch,
    concatenated, then a 3x3 depthwise and a 1x1 conv (hard-swish)."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int, stride: int = 2,
                 deploy: bool = True):
        super().__init__()
        half, half_mid = out_channels // 2, mid_channels // 2
        self.conv_dw_1 = ConvBN(in_channels, in_channels, 3, stride, deploy=deploy,
                                groups=in_channels)
        self.conv_1 = ConvBNHS(in_channels, half, 1, 1, deploy=deploy)
        self.conv_pw_2 = ConvBNHS(in_channels, half_mid, 1, 1, deploy=deploy)
        self.conv_dw_2 = ConvBN(half_mid, half_mid, 3, stride, deploy=deploy,
                                groups=half_mid)
        self.se = SEBlock(half_mid)
        self.conv_2 = ConvBNHS(half_mid, half, 1, 1, deploy=deploy)
        self.conv_dw_3 = ConvBNHS(out_channels, out_channels, 3, 1, deploy=deploy,
                                  groups=out_channels)
        self.conv_pw_3 = ConvBNHS(out_channels, out_channels, 1, 1, deploy=deploy)

    def forward(self, x):
        x1 = self.conv_1(self.conv_dw_1(x))
        x2 = self.conv_2(self.se(self.conv_dw_2(self.conv_pw_2(x))))
        return self.conv_pw_3(self.conv_dw_3(torch.cat([x1, x2], 1)))


class DPBlock(nn.Module):
    """Depthwise-separable conv with hard-swish (JAX: common.py:943-973): a
    ``kernel_size`` depthwise conv, then a 1x1 conv, each with a bias of its
    own in both forms; the train form puts a BN after each (``bn_1``,
    ``bn_2``)."""

    def __init__(self, channels: int, kernel_size: int = 3, stride: int = 1,
                 deploy: bool = True):
        super().__init__()
        self.conv_dw_1 = nn.Conv2d(channels, channels, kernel_size, stride,
                                   (kernel_size - 1) // 2, groups=channels)
        self.conv_pw_1 = nn.Conv2d(channels, channels, 1)
        self.bn_1 = None if deploy else batch_norm(channels)
        self.bn_2 = None if deploy else batch_norm(channels)

    def forward(self, x):
        x = self.conv_dw_1(x)
        if self.bn_1 is not None:
            x = self.bn_1(x)
        x = self.conv_pw_1(F.hardswish(x))
        if self.bn_2 is not None:
            x = self.bn_2(x)
        return F.hardswish(x)


class DarknetBlock(nn.Module):
    """A 1x1 conv (hard-swish) to ``int(out_channels * expansion)``, then a
    DPBlock of ``out_channels`` (JAX: common.py:976-990), which needs that
    width to be ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 expansion: float = 0.5, deploy: bool = True):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv_1 = ConvBNHS(in_channels, hidden, 1, 1, deploy=deploy)
        self.conv_2 = DPBlock(out_channels, kernel_size, 1, deploy=deploy)

    def forward(self, x):
        return self.conv_2(self.conv_1(x))


class CSPBlock(nn.Module):
    """The lite CSP block (JAX: common.py:993-1011): a 1x1 then a
    DarknetBlock beside a 1x1, concatenated, then a 1x1 (all hard-swish);
    hidden width ``int(out_channels * expand_ratio)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 expand_ratio: float = 0.5, deploy: bool = True):
        super().__init__()
        mid = int(out_channels * expand_ratio)
        self.conv_1 = ConvBNHS(in_channels, mid, 1, 1, deploy=deploy)
        self.blocks = DarknetBlock(mid, mid, kernel_size, 1.0, deploy=deploy)
        self.conv_2 = ConvBNHS(in_channels, mid, 1, 1, deploy=deploy)
        self.conv_3 = ConvBNHS(2 * mid, out_channels, 1, 1, deploy=deploy)

    def forward(self, x):
        return self.conv_3(torch.cat([self.blocks(self.conv_1(x)), self.conv_2(x)], 1))


class RealVGGBlock(ConvModule):
    """RepOpt's plain block (JAX: common.py:611-638): a 3x3 conv + BN + ReLU,
    a ConvModule whose class marks the convs that RepOpt re-initialises and
    masks (solver/repoptimizer.py). Deploy form: the conv with a bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, deploy: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride, "relu", deploy=deploy)


class ScaleLayer(nn.Module):
    """A per-channel scale ``weight``, 1 at init (JAX: common.py:641-659, as
    LinearAddBlock builds it: no shift, ``scale_init`` 1)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))

    def forward(self, x):
        return x * self.weight.to(x.dtype).view(1, -1, 1, 1)


class LinearAddBlock(nn.Module):
    """RepOpt's hyper-search (CSLA) block, then ReLU (JAX: common.py:662-695):
    a bare 3x3 conv ``conv`` scaled by ``scale_conv``, a bare 1x1 conv
    ``conv_1x1`` scaled by ``scale_1x1`` and, when in == out and the stride
    is 1, the input scaled by ``scale_identity``, summed, then one BN
    ``bn``. The scales are learned; their values after the search set the
    RepOpt stage's re-init and gradient masks. The block is train-time
    only: ``deploy`` builds the same graph, as in the JAX package, and the
    fold passes it through (layers/reparam.py)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, deploy: bool = True):
        super().__init__()
        if kernel_size != 3:
            raise ValueError("LinearAddBlock is 3x3")
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=False)
        self.scale_conv = ScaleLayer(out_channels)
        self.conv_1x1 = nn.Conv2d(in_channels, out_channels, 1, stride, 0, bias=False)
        self.scale_1x1 = ScaleLayer(out_channels)
        self.scale_identity = (ScaleLayer(out_channels)
                               if in_channels == out_channels and stride == 1 else None)
        self.bn = batch_norm(out_channels)

    def forward(self, x):
        y = self.scale_conv(self.conv(x)) + self.scale_1x1(self.conv_1x1(x))
        if self.scale_identity is not None:
            y = y + self.scale_identity(x)
        return F.relu(self.bn(y))


def get_block(mode: str):
    """training_mode string -> block class (JAX: common.py:1014-1027). The
    ``ConvBN*`` blocks take ``block(in, out)`` as RepVGGBlock does: kernel 3,
    stride 1."""
    table = {"repvgg": RepVGGBlock, "qarepvgg": QARepVGGBlock, "qarepvggv2": QARepVGGBlockV2,
             "hyper_search": LinearAddBlock, "repopt": RealVGGBlock,
             "conv_relu": ConvBNReLU, "conv_silu": ConvBNSiLU}
    if mode not in table:
        raise NotImplementedError(f"undefined rep-block mode {mode!r} (the port has "
                                  f"{sorted(table)})")
    return table[mode]
