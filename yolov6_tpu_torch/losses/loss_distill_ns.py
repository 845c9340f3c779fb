"""N/S self-distillation loss (port of yolov6_tpu/losses/loss_distill_ns.py).

The M/L distillation loss over the distill-NS head's two regression
branches: DFL and the DFL KD train the distribution branch (``"reg_dist"``,
train-only), and the IoU losses of both branches, the DFL-decoded one and
the plain ltrb one that ships, are summed.
"""

from __future__ import annotations

from yolov6_tpu_torch.losses.loss_distill import ComputeLossDistill
from yolov6_tpu_torch.models.effidehead import flatten_maps
from yolov6_tpu_torch.ops.boxes import dist2bbox


class ComputeLossDistillNS(ComputeLossDistill):
    """``ComputeLossDistill`` for the ``DetectDistillNS`` head: ``use_dfl``
    and ``reg_max`` describe its ``"reg_dist"`` branch."""

    def _pred_distri(self, head_out, pred_distri):
        # the flattened "reg" is the plain ltrb branch; the DFL branch is reg_dist
        return flatten_maps(head_out["reg_dist"])

    def _iou_branch_bboxes(self, head_out, anchor_points_s, pred_bboxes):
        pred_ltrb = flatten_maps(head_out["reg"])
        return [pred_bboxes, dist2bbox(pred_ltrb, anchor_points_s[None])]
