"""Anchor points (port of yolov6_tpu/assigners/anchor_generator.py:16-62),
built on the device: one anchor a cell (``mode="af"``) or three
(``mode="ab"``, the fuse-AB branch)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def generate_anchors(
    feats_hw: Sequence[Tuple[int, int]],
    fpn_strides: Sequence[int],
    grid_cell_size: float = 5.0,
    grid_cell_offset: float = 0.5,
    is_eval: bool = False,
    mode: str = "af",
    device=None,
):
    """Grid points of each level, the levels concatenated and each in
    row-major (h, w) order, as the JAX ``generate_anchors``. ``mode="ab"``
    repeats each level's grid three times, anchor-major (the whole grid, then
    the whole grid again, as ``np.tile``), the order of the fuse-AB head's
    flattened maps.

    Eval (``is_eval=True``): ``anchor_points [A, 2]`` (x, y) in grid units and
    ``stride_tensor [A, 1]``. Train: ``anchors [A, 4]`` (xyxy boxes of
    ``grid_cell_size`` strides around each point), ``anchor_points [A, 2]`` in
    pixels, ``num_anchors_list`` and ``stride_tensor [A, 1]``."""
    if mode not in ("af", "ab"):
        raise ValueError(f"anchor mode {mode!r}: 'af' or 'ab'")
    rep = 3 if mode == "ab" else 1
    anchors, anchor_points, stride_tensor, num_anchors_list = [], [], [], []
    for (h, w), stride in zip(feats_hw, fpn_strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        if not is_eval:
            sx, sy = sx * stride, sy * stride
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts = torch.stack([gx, gy], -1).reshape(-1, 2)
        if not is_eval:
            half = grid_cell_size * stride * 0.5
            anchors.append(torch.cat([pts - half, pts + half], -1).repeat(rep, 1))
        anchor_points.append(pts.repeat(rep, 1))
        num_anchors_list.append(h * w * rep)
        stride_tensor.append(torch.full((h * w * rep, 1), float(stride), device=device))
    anchor_points, stride_tensor = torch.cat(anchor_points), torch.cat(stride_tensor)
    if is_eval:
        return anchor_points, stride_tensor
    return torch.cat(anchors), anchor_points, num_anchors_list, stride_tensor
