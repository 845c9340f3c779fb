"""Self-distillation loss of M/L (port of yolov6_tpu/losses/loss_distill.py).

The VFL + IoU + DFL loss of ``ComputeLoss``, plus knowledge distillation
from a teacher's head: class KD (a KL divergence at temperature T, times
T²), DFL KD over the ``reg_max + 1``-bin distributions on positive anchors,
and optionally channel-wise KD on the neck maps, every KD term decayed by a
cosine over the epochs. The reference's quirks are kept, since the tests
hold them: the class KD softmaxes post-sigmoid scores again; the DFL KD is
the mean KL over positive anchors times the sum of the box weights; the
denominator guard is ``target_scores_sum > 0``. Across ranks the
normalisers (``target_scores_sum``, the positive count and the box weights'
sum of the DFL KD, the channel-wise KD's batch) are the global batch's, as
in ``losses/loss.py``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from yolov6_tpu_torch.assigners.atss_assigner import atss_assigner
from yolov6_tpu_torch.assigners.tal_assigner import task_aligned_assigner
from yolov6_tpu_torch.losses.loss import ComputeLoss, bbox_decode, df_loss, varifocal_loss
from yolov6_tpu_torch.models.effidehead import flatten_head_outputs
from yolov6_tpu_torch.ops.boxes import bbox2dist, elementwise_box_iou, xywh2xyxy
from yolov6_tpu_torch.parallel.dist import global_sum, world_size


def _kl_terms(student, teacher, temperature, dim):
    """``p_t · (log p_t − log p_s)`` elementwise, the softmaxes at
    ``temperature`` over ``dim``, in fp32; ``log p_t`` as the reference
    takes it, the log of the probability floored at 1e-30."""
    log_p_s = torch.log_softmax(student.float() / temperature, dim)
    p_t = torch.softmax(teacher.float() / temperature, dim)
    return p_t * (torch.log(p_t.clamp(min=1e-30)) - log_p_s)


def distill_loss_cls(logits_student, logits_teacher, num_classes: int, temperature):
    """KL(teacher ‖ student) over the classes at ``temperature``, summed, times
    T² (JAX: loss_distill.py:24-33). The inputs are post-sigmoid scores,
    softmaxed again over the classes, as the reference does."""
    s = logits_student.reshape(-1, num_classes)
    t = logits_teacher.reshape(-1, num_classes)
    return _kl_terms(s, t, temperature, 1).sum() * temperature ** 2


def distill_loss_dfl_per_anchor(student_dist, teacher_dist, temperature, reg_max: int):
    """Per-anchor mean over the 4 sides of the KL between the bin
    distributions ``[..., 4, reg_max + 1]``, times T² (JAX:
    loss_distill.py:36-45); returns ``[...]``."""
    return _kl_terms(student_dist, teacher_dist, temperature, -1).sum(-1).mean(-1) \
        * temperature ** 2


def distill_loss_cw(s_feats, t_feats, temperature: float = 1.0):
    """Channel-wise KD over the neck maps (JAX: loss_distill.py:48-60): for
    each channel a softmax over its spatial positions (the last two axes of
    an NCHW map), the KL summed and divided by batch times channels, times
    T². The batch is the global one: across ranks each rank's share of the
    sum over it. The teacher's maps are data, not a gradient path."""
    total = 0.0
    for s, t in zip(s_feats, t_feats):
        n, c = s.shape[:2]
        s2 = s.float().reshape(n, c, -1) / temperature
        t2 = t.detach().float().reshape(n, c, -1) / temperature
        log_p_s = torch.log_softmax(s2, -1)
        log_p_t = torch.log_softmax(t2, -1)
        total = total + (log_p_t.exp() * (log_p_t - log_p_s)).sum() * temperature ** 2 \
            / (n * world_size() * c)
    return total


class ComputeLossDistill(ComputeLoss):
    """The M/L distillation loss (JAX: loss_distill.py:63-243) over the
    student's head maps ``head_out``, the teacher's ``t_head_out``, both
    models' neck maps, padded targets and the epoch (a number or a device
    scalar: the KD terms decay with it and nothing is read back). Returns
    the loss and ``components = [iou, dfl + dfl KD, cls + class KD, cwd]``,
    weighted and detached. ``ori_img_size`` and ``warmup_epoch`` are taken
    to match the JAX signature; the caller passes ``use_atss``."""

    def __init__(
        self,
        fpn_strides=(8, 16, 32),
        grid_cell_size=5.0,
        grid_cell_offset=0.5,
        num_classes=80,
        ori_img_size=640,
        warmup_epoch=0,
        use_dfl=True,
        reg_max=16,
        iou_type="giou",
        loss_weight={"class": 1.0, "iou": 2.5, "dfl": 0.5, "cwd": 10.0},
        distill_feat=False,
        distill_weight={"class": 1.0, "dfl": 1.0},
        max_epoch=300,
        temperature=20.0,
    ):
        super().__init__(fpn_strides, grid_cell_size, grid_cell_offset, num_classes,
                         ori_img_size, warmup_epoch, use_dfl, reg_max, iou_type, loss_weight)
        self.distill_feat = distill_feat
        self.distill_weight = dict(distill_weight)
        self.max_epoch = max_epoch
        self.temperature = temperature

    # the hooks the NS variant overrides
    def _pred_distri(self, head_out, pred_distri):
        return pred_distri

    def _iou_branch_bboxes(self, head_out, anchor_points_s, pred_bboxes):
        """The decoded boxes whose IoU losses are summed."""
        return [pred_bboxes]

    def __call__(
        self,
        feats_hw: Sequence[Tuple[int, int]],
        head_out: dict,
        t_head_out: dict,
        s_featmaps,
        t_featmaps,
        targets: torch.Tensor,
        epoch_num,
        batch_height: int,
        batch_width: int,
        use_atss: bool,
    ):
        pred_scores, pred_distri = flatten_head_outputs(head_out)
        device = pred_scores.device
        anchors, anchor_points, n_anchors_list, stride_tensor, scale = self._grid(
            feats_hw, batch_height, batch_width, device)
        pred_distri = self._pred_distri(head_out, pred_distri)
        t_pred_scores, t_pred_distri = flatten_head_outputs(t_head_out)
        t_pred_scores, t_pred_distri = t_pred_scores.detach(), t_pred_distri.detach()

        targets = targets.to(device, torch.float32)
        gt_labels = targets[:, :, :1]
        gt_bboxes = xywh2xyxy(targets[:, :, 1:5] * scale)
        mask_gt = (gt_bboxes.sum(-1, keepdim=True) > 0).float()

        anchor_points_s = anchor_points / stride_tensor
        pred_bboxes = bbox_decode(anchor_points_s[None], pred_distri, self.use_dfl, self.reg_max)
        iou_branch_bboxes = self._iou_branch_bboxes(head_out, anchor_points_s, pred_bboxes)

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

        target_labels = torch.where(fg_mask, target_labels, self.num_classes)
        one_hot_label = F.one_hot(target_labels, self.num_classes + 1)[..., :-1].float()
        loss_cls = varifocal_loss(pred_scores, target_scores, one_hot_label)
        target_scores_sum = global_sum(target_scores.sum())
        denom = torch.where(target_scores_sum > 0, target_scores_sum, 1.0)
        loss_cls = loss_cls / denom

        fg = fg_mask.float()
        bbox_weight = target_scores.sum(-1) * fg
        loss_iou = 0.0
        for boxes in iou_branch_bboxes:
            iou = elementwise_box_iou(boxes, target_bboxes, iou_type=self.iou_type,
                                      box_format="xyxy", eps=1e-10)
            loss_iou = loss_iou + ((1.0 - iou) * bbox_weight).sum() / denom

        zero = torch.zeros((), dtype=torch.float32, device=device)
        if self.use_dfl:
            b, a, _ = pred_distri.shape
            s_dist = pred_distri.reshape(b, a, 4, self.reg_max + 1)
            t_dist = t_pred_distri.reshape(b, a, 4, self.reg_max + 1)
            target_ltrb = bbox2dist(anchor_points_s[None], target_bboxes, self.reg_max)
            per_anchor = df_loss(s_dist, target_ltrb, self.reg_max)[..., 0]
            loss_dfl = (per_anchor * bbox_weight).sum() / denom
            # the reference's DFL KD is the mean KL over the positive anchors
            # times the sum of the box weights, not a weighted sum per anchor
            kd = distill_loss_dfl_per_anchor(s_dist, t_dist, self.temperature, self.reg_max)
            kd_mean = (kd * fg).sum() / global_sum(fg.sum()).clamp(min=1.0)
            d_loss_dfl = kd_mean * global_sum(bbox_weight.sum()) / denom
        else:
            loss_dfl = d_loss_dfl = zero

        d_loss_cls = distill_loss_cls(pred_scores, t_pred_scores, self.num_classes,
                                      self.temperature)
        d_loss_cw = distill_loss_cw(s_featmaps, t_featmaps) if self.distill_feat else zero

        if not torch.is_tensor(epoch_num):
            epoch_num = torch.full((), float(epoch_num), device=device)
        decay = ((1 - torch.cos(epoch_num.float() * math.pi / self.max_epoch)) / 2) \
            * (0.01 - 1) + 1
        d_loss_dfl, d_loss_cls, d_loss_cw = d_loss_dfl * decay, d_loss_cls * decay, \
            d_loss_cw * decay

        w, dw = self.loss_weight, self.distill_weight
        loss_cls_all = loss_cls + d_loss_cls * dw["class"]
        loss_dfl_all = loss_dfl + d_loss_dfl * dw["dfl"]
        loss = (w["class"] * loss_cls_all + w["iou"] * loss_iou + w["dfl"] * loss_dfl_all
                + w["cwd"] * d_loss_cw)
        components = torch.stack([w["iou"] * loss_iou, w["dfl"] * loss_dfl_all,
                                  w["class"] * loss_cls_all, w["cwd"] * d_loss_cw])
        return loss, components.detach()
