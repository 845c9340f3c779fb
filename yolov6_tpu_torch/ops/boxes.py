"""Box geometry (port of yolov6_tpu/ops/boxes.py:16-37)."""

from __future__ import annotations

import torch


def xywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] center-size -> corner format."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], -1)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              box_format: str = "xyxy") -> torch.Tensor:
    """ltrb distances from anchor points -> boxes."""
    lt, rb = distance.chunk(2, -1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if box_format == "xyxy":
        return torch.cat([x1y1, x2y2], -1)
    if box_format == "xywh":
        return torch.cat([(x1y1 + x2y2) * 0.5, x2y2 - x1y1], -1)
    raise ValueError(box_format)
