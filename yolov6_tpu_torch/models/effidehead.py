"""Efficient decoupled head, anchor-free, with or without DFL
(port of yolov6_tpu/models/effidehead.py:31-125): the head, the train-branch
flattening, the DFL projection and the eval decode."""

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

    ``forward`` returns ``{"cls": [b, nc, h, w] logits, "reg": [b, 4 *
    (reg_max + 1), h, w]}`` per level, in NCHW: ltrb distances when
    ``reg_max`` is 0, else a DFL distribution of ``reg_max + 1`` bins a side,
    channel ``side * (reg_max + 1) + bin`` as in the JAX package's last axis.
    ``deploy=False`` gives the stems and convs their BN."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 num_anchors: int = 1, reg_max: int = 0, deploy: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.strides = (8, 16, 32) if len(in_channels) == 3 else (8, 16, 32, 64)
        self.stems = nn.ModuleList(ConvBNSiLU(c, c, 1, 1, deploy) for c in in_channels)
        self.cls_convs = nn.ModuleList(ConvBNSiLU(c, c, 3, 1, deploy) for c in in_channels)
        self.reg_convs = nn.ModuleList(ConvBNSiLU(c, c, 3, 1, deploy) for c in in_channels)
        self.cls_preds = nn.ModuleList(nn.Conv2d(c, num_classes * num_anchors, 1)
                                       for c in in_channels)
        self.reg_preds = nn.ModuleList(nn.Conv2d(c, 4 * (reg_max + num_anchors), 1)
                                       for c in in_channels)
        prior_init(self.cls_preds, self.reg_preds)

    def forward(self, feats):
        out = {"cls": [], "reg": []}
        for i, x in enumerate(feats):
            x = self.stems[i](x)
            self._predict(out, i, self.cls_convs[i](x), self.reg_convs[i](x))
        return out

    def _predict(self, out: dict, i: int, cls_feat, reg_feat) -> None:
        """Append level ``i``'s prediction maps to ``out``; the train-only
        branches of the fuse-AB and distill-NS heads add theirs here."""
        out["cls"].append(self.cls_preds[i](cls_feat))
        out["reg"].append(self.reg_preds[i](reg_feat))


def prior_init(cls_preds, reg_preds) -> None:
    """Prior-probability init (reference effidehead.py:49-57): zero weights,
    class biases at the logit of PRIOR_PROB, box biases 1."""
    with torch.no_grad():
        for conv in cls_preds:
            conv.weight.zero_()
            conv.bias.fill_(-math.log((1 - PRIOR_PROB) / PRIOR_PROB))
        for conv in reg_preds:
            conv.weight.zero_()
            conv.bias.fill_(1.0)


def _flatten_nhwc(m: torch.Tensor) -> torch.Tensor:
    """[b, c, h, w] -> [b, h*w, c] in row-major (h, w) anchor order, fp32."""
    b, c = m.shape[:2]
    return m.permute(0, 2, 3, 1).reshape(b, -1, c).float()


def flatten_head_outputs(outputs: dict):
    """Train branch (JAX: effidehead.py:78-83): sigmoid class scores
    ``[b, A, nc]`` and the raw box regression ``[b, A, 4 * (reg_max + 1)]``
    (distances, or the DFL logits for the loss), fp32, the levels
    concatenated in row-major (h, w) anchor order."""
    cls_scores = torch.cat([torch.sigmoid(_flatten_nhwc(c)) for c in outputs["cls"]], 1)
    return cls_scores, flatten_maps(outputs["reg"])


def flatten_maps(maps) -> torch.Tensor:
    """Per-level ``[b, c, h, w]`` maps -> ``[b, A, c]`` fp32, the levels
    concatenated in row-major (h, w) anchor order."""
    return torch.cat([_flatten_nhwc(m) for m in maps], 1)


def dfl_project(reg_out: torch.Tensor, reg_max: int) -> torch.Tensor:
    """DFL decode (JAX: effidehead.py:86-93): ``[b, A, 4 * (reg_max + 1)]``
    logits -> ``[b, A, 4]`` distances, the expectation of a softmax over the
    ``reg_max + 1`` bins of each side, in fp32."""
    b, a = reg_out.shape[:2]
    probs = torch.softmax(reg_out.float().reshape(b, a, 4, reg_max + 1), -1)
    return probs @ torch.arange(reg_max + 1, dtype=torch.float32, device=reg_out.device)


def decode_eval(outputs: dict, num_classes: int, strides: Sequence[int], use_dfl: bool = False,
                reg_max: int = 0) -> torch.Tensor:
    """Eval decode (JAX: effidehead.py:96-125), always in fp32: returns
    ``[b, A, 5+nc]`` rows ``[cx, cy, w, h, 1.0 (obj), class scores...]`` in
    input-image pixels, anchors level by level in row-major (h, w) order.
    ``use_dfl`` projects the distribution to distances first."""
    feats_hw = [tuple(c.shape[2:4]) for c in outputs["cls"]]
    cls_scores, reg_dists = flatten_head_outputs(outputs)
    if cls_scores.shape[-1] != num_classes:
        raise ValueError(f"head has {cls_scores.shape[-1]} classes, expected {num_classes}")
    if use_dfl:
        reg_dists = dfl_project(reg_dists, reg_max)
    anchor_points, stride_tensor = generate_anchors(
        feats_hw, strides, is_eval=True, device=cls_scores.device
    )
    pred_bboxes = dist2bbox(reg_dists, anchor_points[None], box_format="xywh") * stride_tensor[None]
    obj = torch.ones_like(pred_bboxes[..., :1])
    return torch.cat([pred_bboxes, obj, cls_scores], -1)
