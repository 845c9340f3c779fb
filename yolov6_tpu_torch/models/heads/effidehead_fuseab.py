"""The anchor-aided training (fuse-AB) head (port of
yolov6_tpu/models/heads/effidehead_fuseab.py:20-99).

Beside the anchor-free branch, which ships, the train form carries an
anchor-based branch of three anchors a cell: ``cls_preds_ab.{i}`` and
``reg_preds_ab.{i}``, read only by the AB loss. The deploy form is exactly
``Detect``'s deploy graph.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from yolov6_tpu_torch.models.effidehead import Detect, prior_init


class DetectFuseAB(Detect):
    """``Detect`` plus, in the train form (``deploy=False``), the anchor-based
    maps ``"cls_ab"`` ``[b, na * nc, h, w]`` and ``"reg_ab"`` ``[b, na * 4, h,
    w]`` per level, channel ``anchor * nc + class`` (``anchor * 4 + side``)
    as in the JAX package's last axis. ``anchors_init`` holds each level's
    ``na`` (w, h) anchor sizes in image pixels, flat."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80, reg_max: int = 0,
                 anchors_init=(), num_anchors: int = 3, deploy: bool = True):
        super().__init__(in_channels, num_classes, reg_max=reg_max, deploy=deploy)
        self.anchors_init = tuple(tuple(float(v) for v in level) for level in anchors_init)
        self.num_anchors = num_anchors
        self.train_branch = not deploy
        if self.train_branch:
            self.cls_preds_ab = nn.ModuleList(nn.Conv2d(c, num_classes * num_anchors, 1)
                                              for c in in_channels)
            self.reg_preds_ab = nn.ModuleList(nn.Conv2d(c, 4 * num_anchors, 1)
                                              for c in in_channels)
            prior_init(self.cls_preds_ab, self.reg_preds_ab)

    def _predict(self, out: dict, i: int, cls_feat, reg_feat) -> None:
        super()._predict(out, i, cls_feat, reg_feat)
        if self.train_branch:
            out.setdefault("cls_ab", []).append(self.cls_preds_ab[i](cls_feat))
            out.setdefault("reg_ab", []).append(self.reg_preds_ab[i](reg_feat))


def flatten_ab_outputs(outputs: dict, anchors_init, strides: Sequence[int],
                       num_anchors: int = 3):
    """The anchor-based branch flattened and decoded (JAX:
    effidehead_fuseab.py:79-99), fp32: sigmoid class scores ``[b, na * A,
    nc]`` and boxes ``[b, na * A, 4]`` as xywh in stride units, xy the raw
    offsets and wh ``(2 sigmoid)^2`` times the anchor's size over the
    stride. Anchor-major within each level (every cell of anchor 0, then of
    anchor 1, ...), the order of ``generate_anchors(..., mode="ab")``."""
    cls_list, reg_list = [], []
    na = num_anchors
    for i, (cls_map, reg_map) in enumerate(zip(outputs["cls_ab"], outputs["reg_ab"])):
        b, _, h, w = cls_map.shape
        # a non-blocking copy: a blocking one would wait for the device's queue
        anchors = torch.tensor(anchors_init[i], dtype=torch.float32).to(
            cls_map.device, non_blocking=True).reshape(na, 2) / strides[i]
        cls = cls_map.float().reshape(b, na, -1, h, w).permute(0, 1, 3, 4, 2)
        cls_list.append(torch.sigmoid(cls).reshape(b, na * h * w, -1))
        reg = reg_map.float().reshape(b, na, 4, h, w).permute(0, 1, 3, 4, 2)
        wh = (torch.sigmoid(reg[..., 2:4]) * 2) ** 2 * anchors[None, :, None, None, :]
        reg_list.append(torch.cat([reg[..., :2], wh], -1).reshape(b, na * h * w, 4))
    return torch.cat(cls_list, 1), torch.cat(reg_list, 1)
