"""Box geometry (port of yolov6_tpu/ops/boxes.py:16-45, 68-130)."""

from __future__ import annotations

import math

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


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: int) -> torch.Tensor:
    """xyxy boxes -> ltrb distances from the anchor points, clipped to
    ``[0, reg_max - 0.01]`` (the DFL target)."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 0.01)


def elementwise_box_iou(box1: torch.Tensor, box2: torch.Tensor, iou_type: str = "giou",
                        box_format: str = "xyxy", eps: float = 1e-7) -> torch.Tensor:
    """Element-wise IoU menu, iou/giou/diou/ciou/siou, over ``[..., 4]`` boxes
    (JAX: boxes.py:68-130). eps sits where the reference puts it, on the
    heights and on the union; CIoU's ``alpha`` is detached. Returns the IoU
    variant itself (the loss is ``1 - value``)."""
    if box_format == "xywh":
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)

    iw = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
    ih = (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    inter = iw * ih
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)

    if iou_type == "iou":
        return iou
    if iou_type == "giou":
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    if iou_type in ("diou", "ciou"):
        c2 = cw**2 + ch**2 + eps
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
        if iou_type == "diou":
            return iou - rho2 / c2
        v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        alpha = (v / (v - iou + (1 + eps))).detach()
        return iou - (rho2 / c2 + v * alpha)
    if iou_type == "siou":
        s_cw = (b2x1 + b2x2 - b1x1 - b1x2) * 0.5 + eps
        s_ch = (b2y1 + b2y2 - b1y1 - b1y2) * 0.5 + eps
        sigma = torch.sqrt(s_cw**2 + s_ch**2)
        sin_alpha_1 = s_cw.abs() / sigma
        sin_alpha_2 = s_ch.abs() / sigma
        threshold = 2**0.5 / 2
        sin_alpha = torch.where(sin_alpha_1 > threshold, sin_alpha_2, sin_alpha_1)
        angle_cost = torch.cos(torch.arcsin(sin_alpha) * 2 - math.pi / 2)
        rho_x = (s_cw / cw) ** 2
        rho_y = (s_ch / ch) ** 2
        gamma = angle_cost - 2
        distance_cost = 2 - torch.exp(gamma * rho_x) - torch.exp(gamma * rho_y)
        omiga_w = (w1 - w2).abs() / torch.maximum(w1, w2)
        omiga_h = (h1 - h2).abs() / torch.maximum(h1, h2)
        shape_cost = (1 - torch.exp(-omiga_w)) ** 4 + (1 - torch.exp(-omiga_h)) ** 4
        return iou - 0.5 * (distance_cost + shape_cost)
    raise ValueError(f"unknown iou_type {iou_type!r}")
