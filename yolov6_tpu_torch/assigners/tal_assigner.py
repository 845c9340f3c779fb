"""Task-aligned label assigner, batched at fixed shapes (port of
yolov6_tpu/assigners/tal_assigner.py:26-75)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolov6_tpu_torch.assigners.assigner_utils import (
    iou_calculator,
    select_candidates_in_gts,
    select_highest_overlaps,
    topk_mask,
)


@torch.no_grad()
def task_aligned_assigner(
    pd_scores: torch.Tensor,   # [bs, A, nc] (after the sigmoid)
    pd_bboxes: torch.Tensor,   # [bs, A, 4] xyxy, image pixels
    anc_points: torch.Tensor,  # [A, 2] pixels
    gt_labels: torch.Tensor,   # [bs, M, 1], -1 on padded rows
    gt_bboxes: torch.Tensor,   # [bs, M, 4] xyxy
    mask_gt: torch.Tensor,     # [bs, M, 1], 0 on padded rows
    topk: int = 13,
    num_classes: int = 80,
    alpha: float = 1.0,
    beta: float = 6.0,
    eps: float = 1e-9,
):
    """Returns (target_labels [bs, A] int64, target_bboxes [bs, A, 4],
    target_scores [bs, A, nc], fg_mask [bs, A] bool). Runs without autograd
    on detached inputs: the assignment is data, not a gradient path."""
    pd_scores, pd_bboxes = pd_scores.detach(), pd_bboxes.detach()
    bs, A, nc = pd_scores.shape
    M = gt_bboxes.shape[1]

    # task-aligned metric score(label)^alpha * IoU^beta, [bs, M, A]
    gt_idx = gt_labels[..., 0].long().clamp(0, nc - 1)
    bbox_scores = torch.gather(pd_scores, 2, gt_idx[:, None, :].expand(bs, A, M)).transpose(1, 2)
    overlaps = iou_calculator(gt_bboxes, pd_bboxes)
    align_metric = bbox_scores.pow(alpha) * overlaps.pow(beta)

    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes)
    mask_topk = topk_mask(align_metric * mask_in_gts, topk, mask_gt)
    mask_pos = mask_topk * mask_in_gts * mask_gt

    target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(mask_pos, overlaps, M)

    # gather each anchor's GT; padded rows carry label -1, clipped to 0
    flat_idx = target_gt_idx + torch.arange(bs, device=gt_labels.device)[:, None] * M
    target_labels = gt_labels.long().reshape(-1)[flat_idx].clamp(min=0)
    target_bboxes = gt_bboxes.reshape(-1, 4)[flat_idx]
    target_scores = F.one_hot(target_labels, num_classes).to(pd_scores.dtype)
    target_scores = torch.where(fg_mask[..., None] > 0, target_scores, 0.0)

    # normalise by each GT's largest metric
    align_metric = align_metric * mask_pos
    pos_align_metrics = align_metric.amax(-1, keepdim=True)
    pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm_align_metric = (align_metric * pos_overlaps / (pos_align_metrics + eps)).amax(-2)[..., None]
    target_scores = target_scores * norm_align_metric

    return target_labels, target_bboxes, target_scores, fg_mask.bool()
