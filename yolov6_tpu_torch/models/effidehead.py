"""Efficient decoupled head, anchor-free, without DFL
(port of yolov6_tpu/models/effidehead.py:31-125)."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from yolov6_tpu_torch.assigners.anchor_generator import generate_anchors
from yolov6_tpu_torch.layers.common import ConvBNSiLU
from yolov6_tpu_torch.ops.boxes import dist2bbox

PRIOR_PROB = 1e-2


class Detect(nn.Module):
    """Decoupled head over the neck's levels (JAX: effidehead.py:31-75).

    ``forward`` returns ``{"cls": [b, nc, h, w] logits, "reg": [b, 4, h, w]}``
    per level, in NCHW."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 num_anchors: int = 1, reg_max: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self.strides = (8, 16, 32) if len(in_channels) == 3 else (8, 16, 32, 64)
        self.stems = nn.ModuleList(ConvBNSiLU(c, c, 1, 1) for c in in_channels)
        self.cls_convs = nn.ModuleList(ConvBNSiLU(c, c, 3, 1) for c in in_channels)
        self.reg_convs = nn.ModuleList(ConvBNSiLU(c, c, 3, 1) for c in in_channels)
        self.cls_preds = nn.ModuleList(nn.Conv2d(c, num_classes * num_anchors, 1)
                                       for c in in_channels)
        self.reg_preds = nn.ModuleList(nn.Conv2d(c, 4 * (reg_max + num_anchors), 1)
                                       for c in in_channels)
        # prior-probability init (reference effidehead.py:49-57): zero weights,
        # cls bias at the logit of PRIOR_PROB, reg bias 1
        with torch.no_grad():
            for conv in self.cls_preds:
                conv.weight.zero_()
                conv.bias.fill_(-math.log((1 - PRIOR_PROB) / PRIOR_PROB))
            for conv in self.reg_preds:
                conv.weight.zero_()
                conv.bias.fill_(1.0)

    def forward(self, feats):
        cls_outputs, reg_outputs = [], []
        for i, x in enumerate(feats):
            x = self.stems[i](x)
            cls_outputs.append(self.cls_preds[i](self.cls_convs[i](x)))
            reg_outputs.append(self.reg_preds[i](self.reg_convs[i](x)))
        return {"cls": cls_outputs, "reg": reg_outputs}


def _flatten_nhwc(m: torch.Tensor) -> torch.Tensor:
    """[b, c, h, w] -> [b, h*w, c] in row-major (h, w) anchor order, fp32."""
    b, c = m.shape[:2]
    return m.permute(0, 2, 3, 1).reshape(b, -1, c).float()


def decode_eval(outputs: dict, num_classes: int, strides: Sequence[int]) -> torch.Tensor:
    """Eval decode (JAX: effidehead.py:96-125), always in fp32: returns
    ``[b, A, 5+nc]`` rows ``[cx, cy, w, h, 1.0 (obj), class scores...]`` in
    input-image pixels, anchors level by level in row-major (h, w) order."""
    feats_hw = [tuple(c.shape[2:4]) for c in outputs["cls"]]
    cls_scores = torch.cat([torch.sigmoid(_flatten_nhwc(c)) for c in outputs["cls"]], 1)
    reg_dists = torch.cat([_flatten_nhwc(r) for r in outputs["reg"]], 1)
    if cls_scores.shape[-1] != num_classes:
        raise ValueError(f"head has {cls_scores.shape[-1]} classes, expected {num_classes}")
    anchor_points, stride_tensor = generate_anchors(
        feats_hw, strides, device=cls_scores.device
    )
    pred_bboxes = dist2bbox(reg_dists, anchor_points[None], box_format="xywh") * stride_tensor[None]
    obj = torch.ones_like(pred_bboxes[..., :1])
    return torch.cat([pred_bboxes, obj, cls_scores], -1)
