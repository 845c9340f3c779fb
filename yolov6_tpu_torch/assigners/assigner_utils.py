"""Shared assigner ops at fixed shapes (port of
yolov6_tpu/assigners/assigner_utils.py:14-95).

Padded GT rows are masked arithmetically, with no boolean gathers, so every
shape is known before the data is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dist_calculator(gt_bboxes: torch.Tensor, anchor_bboxes: torch.Tensor):
    """Centre distances of [G, 4] GT boxes and [A, 4] anchor boxes, xyxy ->
    (distances [G, A], anchor centres [A, 2])."""
    gt_points = torch.stack([(gt_bboxes[:, 0] + gt_bboxes[:, 2]) / 2.0,
                             (gt_bboxes[:, 1] + gt_bboxes[:, 3]) / 2.0], 1)
    ac_points = torch.stack([(anchor_bboxes[:, 0] + anchor_bboxes[:, 2]) / 2.0,
                             (anchor_bboxes[:, 1] + anchor_bboxes[:, 3]) / 2.0], 1)
    distances = ((gt_points[:, None, :] - ac_points[None, :, :]) ** 2).sum(-1).sqrt()
    return distances, ac_points


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """[A, 2] anchor centres inside [bs, M, 4] xyxy GT boxes -> [bs, M, A]
    float mask."""
    lt = xy_centers[None, None] - gt_bboxes[:, :, None, 0:2]
    rb = gt_bboxes[:, :, None, 2:4] - xy_centers[None, None]
    deltas = torch.cat([lt, rb], -1)
    return (deltas.amin(-1) > eps).to(gt_bboxes.dtype)


def select_highest_overlaps(mask_pos: torch.Tensor, overlaps: torch.Tensor, n_max_boxes: int):
    """An anchor claimed by several GTs goes to the one of highest IoU (the
    first of equal ones, as ``argmax`` takes in both packages). [bs, M, A] ->
    (target_gt_idx [bs, A], fg_mask [bs, A], mask_pos [bs, M, A])."""
    fg_mask = mask_pos.sum(-2)
    mask_multi_gts = fg_mask[:, None, :] > 1
    max_overlaps_idx = overlaps.argmax(1)
    is_max_overlaps = F.one_hot(max_overlaps_idx, n_max_boxes).to(overlaps.dtype).transpose(1, 2)
    mask_pos = torch.where(mask_multi_gts, is_max_overlaps, mask_pos)
    fg_mask = mask_pos.sum(-2)
    target_gt_idx = mask_pos.argmax(-2)
    return target_gt_idx, fg_mask, mask_pos


def iou_calculator(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Pairwise IoU of [bs, M, 4] and [bs, A, 4] xyxy boxes -> [bs, M, A]."""
    px1y1, px2y2 = box1[:, :, None, 0:2], box1[:, :, None, 2:4]
    gx1y1, gx2y2 = box2[:, None, :, 0:2], box2[:, None, :, 2:4]
    x1y1 = torch.maximum(px1y1, gx1y1)
    x2y2 = torch.minimum(px2y2, gx2y2)
    overlap = (x2y2 - x1y1).clamp(min=0).prod(-1)
    area1 = (px2y2 - px1y1).clamp(min=0).prod(-1)
    area2 = (gx2y2 - gx1y1).clamp(min=0).prod(-1)
    union = area1 + area2 - overlap + eps
    return overlap / union


def topk_mask(metrics: torch.Tensor, topk: int, valid_gt: torch.Tensor) -> torch.Tensor:
    """Membership mask of the ``topk`` largest metrics along the last axis
    (JAX ``scatter_topk_mask``), [bs, M, A] -> float [bs, M, A], rows of
    padded GT (``valid_gt [bs, M, 1]`` 0) cleared.

    Ties go to the lower anchor index, as ``jax.lax.top_k`` orders them: a
    stable descending sort, then the first ``topk``. ``torch.topk`` promises
    no order among equal values, and ties are common here (every anchor
    outside a box, or whose box misses it, has metric 0). The JAX package's
    ``approx_max_k`` for A > 1024 is approximate only on a TPU; this is
    exact at every size."""
    idx = torch.sort(metrics, dim=-1, descending=True, stable=True)[1][..., :topk]
    mask = torch.zeros(metrics.shape, dtype=torch.bool, device=metrics.device)
    mask.scatter_(-1, idx, True)
    return (mask & valid_gt.bool()).to(metrics.dtype)
