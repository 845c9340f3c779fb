"""The anchor-based loss of anchor-aided (fuse-AB) training (port of
yolov6_tpu/losses/loss_fuseab.py).

It is not ``ComputeLoss`` over other anchors: three anchors a cell
(``generate_anchors(..., mode="ab")``), TAL with ``topk=26``, no DFL, boxes
decoded as xywh offsets around the anchor points in stride units, and a
denominator guard of ``target_scores_sum > 0`` where the main loss has
``> 1``. Across ranks ``target_scores_sum`` is the global batch's, as in
``losses/loss.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from yolov6_tpu_torch.assigners.tal_assigner import task_aligned_assigner
from yolov6_tpu_torch.losses.loss import ComputeLoss, varifocal_loss
from yolov6_tpu_torch.ops.boxes import elementwise_box_iou, xywh2xyxy
from yolov6_tpu_torch.parallel.dist import global_sum


class ComputeLossAB(ComputeLoss):
    """Loss over the flattened anchor-based branch (``flatten_ab_outputs``)
    and padded targets ``[bs, M, 5]``; returns the loss and ``components =
    [iou, dfl (0), cls]``, weighted and detached. It shares only the anchor
    grid's cache with ``ComputeLoss``. ``ori_img_size`` and ``anchors_init``
    are taken to match the JAX signature; the head decodes the anchors'
    sizes."""

    anchor_mode = "ab"

    def __init__(
        self,
        fpn_strides=(8, 16, 32),
        grid_cell_size=5.0,
        grid_cell_offset=0.5,
        num_classes=80,
        ori_img_size=640,
        iou_type="giou",
        anchors_init: Tuple = (),
        loss_weight={"class": 1.0, "iou": 2.5, "dfl": 0.5},
    ):
        super().__init__(fpn_strides, grid_cell_size, grid_cell_offset, num_classes,
                         ori_img_size, use_dfl=False, reg_max=0, iou_type=iou_type,
                         loss_weight=loss_weight)

    def __call__(
        self,
        feats_hw: Sequence[Tuple[int, int]],
        pred_scores: torch.Tensor,   # [bs, 3A, nc] sigmoid scores
        pred_distri: torch.Tensor,   # [bs, 3A, 4] xywh, wh anchor-decoded
        targets: torch.Tensor,       # [bs, M, 5]
        batch_height: int,
        batch_width: int,
        use_atss: bool = False,      # unused: the AB branch always assigns by TAL
    ):
        device = pred_scores.device
        _, anchor_points, _, stride_tensor, scale = self._grid(feats_hw, batch_height,
                                                               batch_width, device)
        targets = targets.to(device, torch.float32)
        gt_labels = targets[:, :, :1]
        gt_bboxes = xywh2xyxy(targets[:, :, 1:5] * scale)
        mask_gt = (gt_bboxes.sum(-1, keepdim=True) > 0).float()

        anchor_points_s = anchor_points / stride_tensor
        pred_scores, pred_distri = pred_scores.float(), pred_distri.float()
        pred_bboxes = xywh2xyxy(torch.cat([pred_distri[..., :2] + anchor_points_s[None],
                                           pred_distri[..., 2:]], -1))

        target_labels, target_bboxes, target_scores, fg_mask = task_aligned_assigner(
            pred_scores.detach(), pred_bboxes.detach() * stride_tensor, anchor_points,
            gt_labels, gt_bboxes, mask_gt, topk=26, num_classes=self.num_classes,
            alpha=1.0, beta=6.0)
        target_bboxes = target_bboxes / stride_tensor

        target_labels = torch.where(fg_mask, target_labels, self.num_classes)
        one_hot_label = F.one_hot(target_labels, self.num_classes + 1)[..., :-1].float()
        loss_cls = varifocal_loss(pred_scores, target_scores, one_hot_label)
        target_scores_sum = global_sum(target_scores.sum())
        denom = torch.where(target_scores_sum > 0, target_scores_sum, 1.0)
        loss_cls = loss_cls / denom

        bbox_weight = target_scores.sum(-1) * fg_mask.float()
        iou = elementwise_box_iou(pred_bboxes, target_bboxes, iou_type=self.iou_type,
                                  box_format="xyxy", eps=1e-10)
        loss_iou = ((1.0 - iou) * bbox_weight).sum() / denom
        loss_dfl = torch.zeros((), dtype=torch.float32, device=device)

        w = self.loss_weight
        loss = w["class"] * loss_cls + w["iou"] * loss_iou + w["dfl"] * loss_dfl
        components = torch.stack([w["iou"] * loss_iou, w["dfl"] * loss_dfl, w["class"] * loss_cls])
        return loss, components.detach()
