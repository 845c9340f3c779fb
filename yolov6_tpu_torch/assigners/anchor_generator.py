"""Anchor points, eval mode (port of yolov6_tpu/assigners/anchor_generator.py)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def generate_anchors(
    feats_hw: Sequence[Tuple[int, int]],
    fpn_strides: Sequence[int],
    grid_cell_offset: float = 0.5,
    device=None,
):
    """Anchor-free grid points of each level, in grid units, built on ``device``.

    Returns ``anchor_points [A, 2]`` (x, y) and ``stride_tensor [A, 1]``, the
    levels concatenated and each in row-major (h, w) order, as the JAX
    ``generate_anchors(..., is_eval=True, mode='af')`` does."""
    anchor_points, stride_tensor = [], []
    for (h, w), stride in zip(feats_hw, fpn_strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        anchor_points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        stride_tensor.append(torch.full((h * w, 1), float(stride), device=device))
    return torch.cat(anchor_points), torch.cat(stride_tensor)
