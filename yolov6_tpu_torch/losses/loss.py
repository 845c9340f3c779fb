"""Detection loss: VariFocal + IoU + DFL, with ATSS or task-aligned
assignment (port of yolov6_tpu/losses/loss.py:28-204).

As in the JAX package, the per-anchor losses are dense and weighted by
``fg_mask``, the same sums as the reference's masked selects at fixed shapes,
and the assigner runs on the device with the loss.

Across ranks (``parallel/dist.py``) each rank's loss is its own sums over
the global normaliser (``target_scores_sum`` summed over the ranks, its
guard taken on that sum), so the ranks' losses add up to the loss of the
global batch, and the step sums their gradients.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from yolov6_tpu_torch.assigners.anchor_generator import generate_anchors
from yolov6_tpu_torch.assigners.atss_assigner import atss_assigner
from yolov6_tpu_torch.assigners.tal_assigner import task_aligned_assigner
from yolov6_tpu_torch.models.effidehead import dfl_project
from yolov6_tpu_torch.ops.boxes import bbox2dist, dist2bbox, elementwise_box_iou, xywh2xyxy
from yolov6_tpu_torch.parallel.dist import global_sum


def varifocal_loss(pred_score, gt_score, label, alpha=0.75, gamma=2.0):
    """Weighted BCE on probabilities, fp32 (JAX: loss.py:28-38), with torch
    ``binary_cross_entropy``'s clamp of the log terms at -100."""
    pred, gt = pred_score.float(), gt_score.float()
    weight = alpha * pred.pow(gamma) * (1 - label) + gt * label
    bce = -(gt * torch.log(pred.clamp(min=1e-44)).clamp(min=-100)
            + (1 - gt) * torch.log((1 - pred).clamp(min=1e-44)).clamp(min=-100))
    return (bce * weight).sum()


def df_loss(pred_dist_logits, target, reg_max: int):
    """Distribution focal loss (JAX: loss.py:41-52): cross-entropy at the two
    bins around each target distance, weighted by closeness, in fp32.
    ``pred_dist_logits [..., 4, reg_max + 1]``, ``target [..., 4]`` in
    ``[0, reg_max)``; returns the mean over the 4 sides, ``[..., 1]``."""
    target_left = target.long()
    target_right = target_left + 1
    weight_left = target_right.float() - target
    weight_right = 1.0 - weight_left
    logp = torch.log_softmax(pred_dist_logits.float(), -1)
    loss_left = -torch.gather(logp, -1, target_left[..., None])[..., 0] * weight_left
    right_idx = target_right.clamp(0, reg_max)
    loss_right = -torch.gather(logp, -1, right_idx[..., None])[..., 0] * weight_right
    return (loss_left + loss_right).mean(-1, keepdim=True)


def bbox_decode(anchor_points, pred_dist, use_dfl: bool, reg_max: int):
    """Box regression -> xyxy boxes (JAX: loss.py:55-62): ltrb distances, or
    with ``use_dfl`` the expectation of each side's distribution."""
    if use_dfl:
        pred_dist = dfl_project(pred_dist, reg_max)
    return dist2bbox(pred_dist, anchor_points)


class ComputeLoss:
    """Loss over (feats_hw, cls_scores, reg_distri) and padded targets
    (JAX: loss.py:65-204). Targets are ``[bs, M, 5]`` rows (cls, cx, cy, w,
    h), normalised; padded rows have cls -1 and boxes 0. ``use_atss`` picks
    ATSS (top 9 a level) over TAL (top 13) for the call, as the trainer does
    in its warmup epochs. Returns the loss and ``components = [iou, dfl,
    cls]``, weighted and detached (dfl 0 without DFL). ``ori_img_size`` and
    ``warmup_epoch`` are taken to match the JAX signature and unused: the
    caller passes ``use_atss``."""

    def __init__(
        self,
        fpn_strides=(8, 16, 32),
        grid_cell_size=5.0,
        grid_cell_offset=0.5,
        num_classes=80,
        ori_img_size=640,
        warmup_epoch=4,
        use_dfl=True,
        reg_max=16,
        iou_type="giou",
        loss_weight={"class": 1.0, "iou": 2.5, "dfl": 0.5},
    ):
        self.fpn_strides = tuple(fpn_strides)
        self.grid_cell_size = grid_cell_size
        self.grid_cell_offset = grid_cell_offset
        self.num_classes = num_classes
        self.use_dfl = use_dfl
        self.reg_max = reg_max
        self.iou_type = iou_type
        self.loss_weight = dict(loss_weight)
        self._grids = {}

    anchor_mode = "af"  # generate_anchors' mode; the fuse-AB loss's is "ab"

    def _grid(self, feats_hw, batch_height, batch_width, device):
        """Anchor boxes [A, 4] and points [A, 2] px, anchors per level,
        strides [A, 1] and the target scale, made once per input size and
        device."""
        key = (tuple(map(tuple, feats_hw)), batch_height, batch_width, str(device))
        if key not in self._grids:
            anchors = generate_anchors(feats_hw, self.fpn_strides, self.grid_cell_size,
                                       self.grid_cell_offset, mode=self.anchor_mode,
                                       device=device)
            scale = torch.tensor([batch_width, batch_height, batch_width, batch_height],
                                 dtype=torch.float32, device=device)
            self._grids[key] = anchors + (scale,)
        return self._grids[key]

    def __call__(
        self,
        feats_hw: Sequence[Tuple[int, int]],
        pred_scores: torch.Tensor,   # [bs, A, nc] sigmoid scores
        pred_distri: torch.Tensor,   # [bs, A, 4 * (reg_max + 1)]
        targets: torch.Tensor,       # [bs, M, 5]
        batch_height: int,
        batch_width: int,
        use_atss: bool,
    ):
        device = pred_scores.device
        anchors, anchor_points, n_anchors_list, stride_tensor, scale = self._grid(
            feats_hw, batch_height, batch_width, device)
        targets = targets.to(device, torch.float32)
        gt_labels = targets[:, :, :1]
        gt_bboxes = xywh2xyxy(targets[:, :, 1:5] * scale)
        mask_gt = (gt_bboxes.sum(-1, keepdim=True) > 0).float()

        anchor_points_s = anchor_points / stride_tensor
        pred_scores, pred_distri = pred_scores.float(), pred_distri.float()
        pred_bboxes = bbox_decode(anchor_points_s[None], pred_distri, self.use_dfl, self.reg_max)

        detached_boxes = pred_bboxes.detach() * stride_tensor
        if use_atss:
            target_labels, target_bboxes, target_scores, fg_mask = atss_assigner(
                anchors, n_anchors_list, gt_labels, gt_bboxes, mask_gt, detached_boxes,
                topk=9, num_classes=self.num_classes)
        else:
            target_labels, target_bboxes, target_scores, fg_mask = task_aligned_assigner(
                pred_scores, detached_boxes, anchor_points, gt_labels, gt_bboxes, mask_gt,
                topk=13, num_classes=self.num_classes, alpha=1.0, beta=6.0)
        target_bboxes = target_bboxes / stride_tensor

        # class loss
        target_labels = torch.where(fg_mask, target_labels, self.num_classes)
        one_hot_label = F.one_hot(target_labels, self.num_classes + 1)[..., :-1].float()
        loss_cls = varifocal_loss(pred_scores, target_scores, one_hot_label)
        target_scores_sum = global_sum(target_scores.sum())
        denom = torch.where(target_scores_sum > 1, target_scores_sum, 1.0)
        loss_cls = loss_cls / denom

        # box loss, dense and weighted by fg_mask
        bbox_weight = target_scores.sum(-1) * fg_mask.float()
        iou = elementwise_box_iou(pred_bboxes, target_bboxes, iou_type=self.iou_type,
                                  box_format="xyxy", eps=1e-10)
        loss_iou = ((1.0 - iou) * bbox_weight).sum() / denom
        if self.use_dfl:
            b, a, _ = pred_distri.shape
            target_ltrb = bbox2dist(anchor_points_s[None], target_bboxes, self.reg_max)
            per_anchor = df_loss(pred_distri.reshape(b, a, 4, self.reg_max + 1), target_ltrb,
                                 self.reg_max)[..., 0]
            loss_dfl = (per_anchor * bbox_weight).sum() / denom
        else:
            loss_dfl = torch.zeros((), dtype=torch.float32, device=device)

        w = self.loss_weight
        loss = w["class"] * loss_cls + w["iou"] * loss_iou + w["dfl"] * loss_dfl
        components = torch.stack([w["iou"] * loss_iou, w["dfl"] * loss_dfl, w["class"] * loss_cls])
        return loss, components.detach()
