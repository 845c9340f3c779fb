"""The lite family's decoupled head (port of
yolov6_tpu/models/heads/effidehead_lite.py:19-57): ``Detect``'s decode scheme
with 5x5 depthwise-separable convs and no DFL."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from yolov6_tpu_torch.layers.common import DPBlock
from yolov6_tpu_torch.models.effidehead import prior_init


class DetectLite(nn.Module):
    """Lite head over the neck's four levels (strides 8-64), one anchor a cell.

    Each level runs a 5x5 ``DPBlock`` stem, then a ``DPBlock`` and a 1x1
    prediction conv for the classes and another pair for the ltrb box
    distances; the predictions start at zero weights with the class-prior
    bias and a box bias of 1. ``forward`` returns ``{"cls", "reg", "stems"}``
    per level in NCHW, as ``Detect`` returns ``cls`` and ``reg``, so that the
    decode, the train branch's flattening and the loss take it as they
    take ``Detect``'s."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80, deploy: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.strides = (8, 16, 32, 64)
        self.stems = nn.ModuleList(DPBlock(c, 5, 1, deploy=deploy) for c in in_channels)
        self.cls_convs = nn.ModuleList(DPBlock(c, 5, 1, deploy=deploy) for c in in_channels)
        self.reg_convs = nn.ModuleList(DPBlock(c, 5, 1, deploy=deploy) for c in in_channels)
        self.cls_preds = nn.ModuleList(nn.Conv2d(c, num_classes, 1) for c in in_channels)
        self.reg_preds = nn.ModuleList(nn.Conv2d(c, 4, 1) for c in in_channels)
        prior_init(self.cls_preds, self.reg_preds)

    def forward(self, feats):
        out = {"cls": [], "reg": [], "stems": []}
        for i, x in enumerate(feats):
            x = self.stems[i](x)
            out["stems"].append(x)
            out["cls"].append(self.cls_preds[i](self.cls_convs[i](x)))
            out["reg"].append(self.reg_preds[i](self.reg_convs[i](x)))
        return out
