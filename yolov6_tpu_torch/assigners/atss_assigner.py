"""ATSS (adaptive training sample selection) assigner, batched at fixed shapes
(port of yolov6_tpu/assigners/atss_assigner.py:19-101): the assigner of the
warmup epochs before TAL."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from yolov6_tpu_torch.assigners.assigner_utils import (
    dist_calculator,
    iou_calculator,
    select_candidates_in_gts,
    select_highest_overlaps,
)


def _pairwise_iou(gt_flat: torch.Tensor, anchors: torch.Tensor, eps: float = 1e-6):
    """IoU of [G, 4] and [A, 4] xyxy boxes -> [G, A]."""
    lt = torch.maximum(gt_flat[:, None, :2], anchors[None, :, :2])
    rb = torch.minimum(gt_flat[:, None, 2:], anchors[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area1 = (gt_flat[:, 2:] - gt_flat[:, :2]).clamp(min=0).prod(-1)
    area2 = (anchors[:, 2:] - anchors[:, :2]).clamp(min=0).prod(-1)
    union = (area1[:, None] + area2[None, :] - inter).clamp(min=eps)
    return inter / union


def _per_level_topk(distances: torch.Tensor, n_level_bboxes: Sequence[int], topk: int,
                    mask_gt: torch.Tensor):
    """The ``topk`` anchors of each level nearest each GT. Returns
    (is_in_candidate [bs, M, A] float, candidate_idxs [bs, M, sum of k]).

    Among equal distances the lower index comes first, as ``lax.top_k(-d)``
    orders them (a stable ascending sort, then the first k): a GT centre on a
    cell edge is equally far from the cells on both sides. A padded GT row
    points all its k candidates at index 0 of each level, and a count above
    1 clears them, as in the JAX package (its ``candidate_idxs`` stay the
    unmasked ones)."""
    is_in_candidate, candidate_idxs = [], []
    start = 0
    mask = mask_gt.bool()
    for n_level in n_level_bboxes:
        k = min(topk, n_level)
        level_dist = distances[..., start:start + n_level]
        idxs = torch.sort(level_dist, dim=-1, stable=True)[1][..., :k]
        candidate_idxs.append(idxs + start)
        idxs = torch.where(mask, idxs, 0)
        counts = torch.zeros(level_dist.shape, dtype=torch.int32, device=distances.device)
        counts.scatter_add_(-1, idxs, torch.ones_like(idxs, dtype=torch.int32))
        is_in_candidate.append(torch.where(counts > 1, 0, counts).to(distances.dtype))
        start += n_level
    return torch.cat(is_in_candidate, -1), torch.cat(candidate_idxs, -1)


@torch.no_grad()
def atss_assigner(
    anc_bboxes: torch.Tensor,      # [A, 4] xyxy anchor boxes, pixels
    n_level_bboxes: Sequence[int],
    gt_labels: torch.Tensor,       # [bs, M, 1], -1 on padded rows
    gt_bboxes: torch.Tensor,       # [bs, M, 4] xyxy
    mask_gt: torch.Tensor,         # [bs, M, 1], 0 on padded rows
    pd_bboxes: torch.Tensor,       # [bs, A, 4] xyxy or None: the soft labels' IoU source
    topk: int = 9,
    num_classes: int = 80,
):
    """Returns (target_labels [bs, A] int64, num_classes where background,
    target_bboxes [bs, A, 4], target_scores [bs, A, nc], fg_mask [bs, A]
    bool). A GT's positives are its candidates whose IoU with it exceeds the
    candidates' mean + unbiased std and whose centre lies inside it; with
    ``pd_bboxes`` the one-hot scores are scaled by the predicted box's IoU
    with its GT. Runs without autograd: the assignment is data."""
    A = anc_bboxes.shape[0]
    bs, M, _ = gt_bboxes.shape
    gt_flat = gt_bboxes.reshape(-1, 4)
    overlaps = _pairwise_iou(gt_flat, anc_bboxes).reshape(bs, M, A)
    distances, ac_points = dist_calculator(gt_flat, anc_bboxes)
    distances = distances.reshape(bs, M, A)

    is_in_candidate, candidate_idxs = _per_level_topk(distances, n_level_bboxes, topk, mask_gt)

    # IoU threshold per GT: mean + std of its candidates' IoUs
    candidate_overlaps_map = torch.where(is_in_candidate > 0, overlaps, 0.0)
    gathered = torch.gather(candidate_overlaps_map, 2, candidate_idxs)
    thr = gathered.mean(-1, keepdim=True) + gathered.std(-1, keepdim=True)

    is_pos = torch.where(candidate_overlaps_map > thr, is_in_candidate, 0.0)
    is_in_gts = select_candidates_in_gts(ac_points, gt_bboxes)
    mask_pos = is_pos * is_in_gts * mask_gt

    target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(mask_pos, overlaps, M)

    flat_idx = target_gt_idx + torch.arange(bs, device=gt_labels.device)[:, None] * M
    target_labels = gt_labels.long().reshape(-1)[flat_idx]
    target_labels = torch.where(fg_mask > 0, target_labels, num_classes)
    target_bboxes = gt_bboxes.reshape(-1, 4)[flat_idx]
    # a label of -1 (never on a positive) gives a zero row, as jax.nn.one_hot does
    target_scores = (F.one_hot(target_labels.clamp(min=0), num_classes + 1)[..., :num_classes]
                     * (target_labels >= 0)[..., None]).to(gt_bboxes.dtype)

    if pd_bboxes is not None:
        ious = (iou_calculator(gt_bboxes, pd_bboxes.detach()) * mask_pos).amax(-2)[..., None]
        target_scores = target_scores * ious

    return target_labels, target_bboxes, target_scores, fg_mask.bool()
