"""Detection loss: VariFocal + IoU with task-aligned assignment (port of
yolov6_tpu/losses/loss.py:28-204, the path YOLOv6-S trains with: TAL only,
no DFL).

As in the JAX package, the per-anchor losses are dense and weighted by
``fg_mask``, the same sums as the reference's masked selects at fixed shapes,
and the assigner runs on the device with the loss.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from yolov6_tpu_torch.assigners.anchor_generator import generate_anchors
from yolov6_tpu_torch.assigners.tal_assigner import task_aligned_assigner
from yolov6_tpu_torch.ops.boxes import dist2bbox, elementwise_box_iou, xywh2xyxy

NEXT_SLICE = "the M/L slice of the port (ATSS, DFL)"


def varifocal_loss(pred_score, gt_score, label, alpha=0.75, gamma=2.0):
    """Weighted BCE on probabilities, fp32 (JAX: loss.py:28-38), with torch
    ``binary_cross_entropy``'s clamp of the log terms at -100."""
    pred, gt = pred_score.float(), gt_score.float()
    weight = alpha * pred.pow(gamma) * (1 - label) + gt * label
    bce = -(gt * torch.log(pred.clamp(min=1e-44)).clamp(min=-100)
            + (1 - gt) * torch.log((1 - pred).clamp(min=1e-44)).clamp(min=-100))
    return (bce * weight).sum()


def bbox_decode(anchor_points, pred_dist, use_dfl: bool, reg_max: int):
    """ltrb distances -> xyxy boxes (JAX: loss.py:55-62, no DFL)."""
    if use_dfl:
        raise NotImplementedError(f"DFL decoding comes with {NEXT_SLICE}")
    return dist2bbox(pred_dist, anchor_points)


class ComputeLoss:
    """Loss over (feats_hw, cls_scores, reg_distri) and padded targets
    (JAX: loss.py:65-204). Targets are ``[bs, M, 5]`` rows (cls, cx, cy, w,
    h), normalised; padded rows have cls -1 and boxes 0. Returns the loss and
    ``components = [iou, dfl (0), cls]``, weighted and detached.
    ``ori_img_size`` and ``warmup_epoch`` are taken to match the JAX
    signature and unused: only TAL assigns in this port."""

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
        if use_dfl:
            raise NotImplementedError(f"the DF loss comes with {NEXT_SLICE}")
        self.fpn_strides = tuple(fpn_strides)
        self.grid_cell_size = grid_cell_size
        self.grid_cell_offset = grid_cell_offset
        self.num_classes = num_classes
        self.use_dfl = use_dfl
        self.reg_max = reg_max
        self.iou_type = iou_type
        self.loss_weight = dict(loss_weight)
        self._grids = {}

    def _grid(self, feats_hw, batch_height, batch_width, device):
        """Anchor points [A, 2] px, strides [A, 1] and the target scale, made
        once per input size and device."""
        key = (tuple(map(tuple, feats_hw)), batch_height, batch_width, str(device))
        if key not in self._grids:
            _, anchor_points, _, stride_tensor = generate_anchors(
                feats_hw, self.fpn_strides, self.grid_cell_size, self.grid_cell_offset,
                device=device)
            scale = torch.tensor([batch_width, batch_height, batch_width, batch_height],
                                 dtype=torch.float32, device=device)
            self._grids[key] = anchor_points, stride_tensor, scale
        return self._grids[key]

    def __call__(
        self,
        feats_hw: Sequence[Tuple[int, int]],
        pred_scores: torch.Tensor,   # [bs, A, nc] sigmoid scores
        pred_distri: torch.Tensor,   # [bs, A, 4]
        targets: torch.Tensor,       # [bs, M, 5]
        batch_height: int,
        batch_width: int,
        use_atss: bool,
    ):
        if use_atss:
            raise NotImplementedError(f"the ATSS assigner comes with {NEXT_SLICE}")
        device = pred_scores.device
        anchor_points, stride_tensor, scale = self._grid(feats_hw, batch_height, batch_width,
                                                         device)
        targets = targets.to(device, torch.float32)
        gt_labels = targets[:, :, :1]
        gt_bboxes = xywh2xyxy(targets[:, :, 1:5] * scale)
        mask_gt = (gt_bboxes.sum(-1, keepdim=True) > 0).float()

        anchor_points_s = anchor_points / stride_tensor
        pred_scores, pred_distri = pred_scores.float(), pred_distri.float()
        pred_bboxes = bbox_decode(anchor_points_s[None], pred_distri, self.use_dfl, self.reg_max)

        target_labels, target_bboxes, target_scores, fg_mask = task_aligned_assigner(
            pred_scores, pred_bboxes.detach() * stride_tensor, anchor_points, gt_labels,
            gt_bboxes, mask_gt, topk=13, num_classes=self.num_classes, alpha=1.0, beta=6.0)
        target_bboxes = target_bboxes / stride_tensor

        # class loss
        target_labels = torch.where(fg_mask, target_labels, self.num_classes)
        one_hot_label = F.one_hot(target_labels, self.num_classes + 1)[..., :-1].float()
        loss_cls = varifocal_loss(pred_scores, target_scores, one_hot_label)
        target_scores_sum = target_scores.sum()
        denom = torch.where(target_scores_sum > 1, target_scores_sum, 1.0)
        loss_cls = loss_cls / denom

        # box loss, dense and weighted by fg_mask
        bbox_weight = target_scores.sum(-1) * fg_mask.float()
        iou = elementwise_box_iou(pred_bboxes, target_bboxes, iou_type=self.iou_type,
                                  box_format="xyxy", eps=1e-10)
        loss_iou = ((1.0 - iou) * bbox_weight).sum() / denom
        loss_dfl = torch.zeros((), dtype=torch.float32, device=device)

        w = self.loss_weight
        loss = w["class"] * loss_cls + w["iou"] * loss_iou + w["dfl"] * loss_dfl
        components = torch.stack([w["iou"] * loss_iou, w["dfl"] * loss_dfl, w["class"] * loss_cls])
        return loss, components.detach()
