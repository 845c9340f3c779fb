"""The distill-NS head of N/S self-distillation (port of
yolov6_tpu/models/heads/effidehead_distill_ns.py:19-63).

Its ``reg_preds.{i}`` regresses plain ltrb distances (4 channels) and ships;
the train form adds ``reg_preds_dist.{i}``, a DFL distribution of
``reg_max + 1`` bins a side that only the distillation loss reads, so the
distillation costs nothing at deploy. The deploy form is exactly ``Detect``'s
deploy graph without DFL.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from yolov6_tpu_torch.models.effidehead import Detect, prior_init


class DetectDistillNS(Detect):
    """``Detect`` with ltrb ``"reg"`` maps and, in the train form
    (``deploy=False``), the ``"reg_dist"`` maps ``[b, 4 * (reg_max + 1), h,
    w]`` per level. ``reg_max`` sizes that train-only branch."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80, reg_max: int = 16,
                 deploy: bool = True):
        super().__init__(in_channels, num_classes, reg_max=0, deploy=deploy)
        self.reg_max = reg_max
        self.train_branch = not deploy
        if self.train_branch:
            self.reg_preds_dist = nn.ModuleList(nn.Conv2d(c, 4 * (reg_max + 1), 1)
                                                for c in in_channels)
            prior_init([], self.reg_preds_dist)

    def _predict(self, out: dict, i: int, cls_feat, reg_feat) -> None:
        super()._predict(out, i, cls_feat, reg_feat)
        if self.train_branch:
            out.setdefault("reg_dist", []).append(self.reg_preds_dist[i](reg_feat))
