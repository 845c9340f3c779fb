"""Fixed-shape batched NMS (port of yolov6_tpu/ops/nms.py:293-563).

Every step keeps static shapes, as in the JAX package:

  1. conf = obj * cls; multi-label candidates come from the [A, nc] score
     grid, below ``conf_thres`` zeroed.
  2. exact top-k to ``max_nms`` candidates, ties lowest index first (a
     stable descending sort, as ``lax.top_k`` orders them).
  3. class offset: boxes shifted by class * MAX_WH so one IoU geometry does
     per-class NMS.
  4. the greedy keep (ops/cuda/nms_kernel.py): the CUDA kernel on a CUDA
     tensor, the plain torch loop on a CPU tensor.

Outputs are ``dets [b, max_det, 6]`` (xyxy, conf, cls) with invalid rows
zeroed, and ``valid [b, max_det]``. The JAX package's TPU levers
(approx_max_k, bf16 selection, the optimization barrier) are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from yolov6_tpu_torch.ops.boxes import xywh2xyxy
from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms, greedy_nms_plain

MAX_WH = 4096  # reference: utils/nms.py:54


def _topk(vals: torch.Tensor, k: int):
    """Exact top-k along the last axis, descending, ties lowest index first."""
    v, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] gathered along axis 1 at idx [B, K]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _select_candidates(
    pred: torch.Tensor,
    conf_thres: float,
    max_nms: int,
    multi_label: bool,
    agnostic: bool,
    class_mask: Optional[torch.Tensor],
    anchor_topc: int = 8,
    row_select: str = "grouped",
):
    """Batched candidate selection over ``pred [B, A, 5+nc]`` (JAX:
    nms.py:293-411 with ``exact_topk=True``): returns ``(raw_boxes [B,K,4],
    nms_boxes [B,K,4], scores [B,K], cls [B,K])``, scores zeroed below conf.

    Multi-label first shrinks each anchor's nc class scores to
    ``anchor_topc`` (0 disables): ``row_select='grouped'`` keeps the max of
    each residue group c % C, ``'topk'`` the exact per-anchor top C."""
    B, A = pred.shape[:2]
    nc = pred.shape[-1] - 5
    boxes = xywh2xyxy(pred[..., :4])
    scores = pred[..., 5:] * pred[..., 4:5]
    if class_mask is not None:
        scores = scores * class_mask.to(scores)
    if multi_label and nc > 1:
        if 0 < anchor_topc < nc:
            C = anchor_topc
            if row_select == "grouped":
                width = -(-nc // C)
                sc = F.pad(scores, (0, C * width - nc))
                grid = sc.reshape(B, A, width, C).transpose(2, 3)  # class c at [c % C, c // C]
                row_scores = grid.amax(-1)
                local = grid.argmax(-1)
                row_cls = (local * C + torch.arange(C, device=pred.device)).float()
            elif row_select == "topk":
                row_scores, row_cls = _topk(scores, C)
                row_cls = row_cls.float()
            else:
                raise ValueError(f"unknown row_select {row_select!r}")
            flat = row_scores.reshape(B, -1)
            flat = torch.where(flat > conf_thres, flat, 0.0)
            top_scores, top_idx = _topk(flat, min(max_nms, flat.shape[1]))
            box_idx = top_idx // C
            cls_idx = _gather_rows(row_cls.reshape(B, -1), top_idx)
        else:
            flat = scores.reshape(B, -1)
            flat = torch.where(flat > conf_thres, flat, 0.0)
            top_scores, top_idx = _topk(flat, min(max_nms, flat.shape[1]))
            box_idx = top_idx // nc
            cls_idx = (top_idx % nc).float()
    else:
        best = scores.amax(-1)
        cls = scores.argmax(-1).float()
        best = torch.where(best > conf_thres, best, 0.0)
        top_scores, box_idx = _topk(best, min(max_nms, A))
        cls_idx = _gather_rows(cls, box_idx)
    cand_boxes = _gather_rows(boxes, box_idx)
    top_scores = torch.where(top_scores > conf_thres, top_scores, 0.0)
    offset = 0.0 if agnostic else MAX_WH
    nms_boxes = cand_boxes + (cls_idx * offset)[..., None]
    return cand_boxes, nms_boxes, top_scores, cls_idx


def non_max_suppression(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    max_nms: int = 30000,
    multi_label: bool = False,
    agnostic: bool = False,
    class_mask: Optional[torch.Tensor] = None,
    method: Optional[str] = None,
    anchor_topc: int = 8,
    row_select: str = "grouped",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched NMS over ``[b, A, 5+nc]`` predictions (JAX: nms.py:422-563).

    Returns ``(dets [b, max_det, 6] as xyxy/conf/cls, valid [b, max_det])``.
    ``class_mask`` is an optional [nc] 0/1 vector (the reference's
    ``classes`` filter). ``method``: None keeps with ``greedy_nms`` (the CUDA
    kernel on a CUDA tensor, the JAX ``'pallas'`` path; the plain loop on a
    CPU tensor); ``'loop'`` keeps with the plain torch loop on any device
    (the JAX ``'loop'`` path, the kernel's reference)."""
    if method in ("tiled", "perclass"):
        raise NotImplementedError(f"NMS method {method!r} is not ported yet")
    if method not in (None, "loop"):
        raise ValueError(f"unknown NMS method {method!r}")
    cand_boxes, nms_boxes, scores, cls_idx = _select_candidates(
        prediction.float(), conf_thres, max_nms, multi_label, agnostic, class_mask,
        anchor_topc, row_select,
    )
    keep = greedy_nms_plain if method == "loop" else greedy_nms
    idx, valid = keep(nms_boxes.contiguous(), scores.contiguous(), max_det, iou_thres)
    idx = idx.long()
    dets = torch.cat([
        _gather_rows(cand_boxes, idx),
        _gather_rows(scores, idx)[..., None],
        _gather_rows(cls_idx, idx)[..., None],
    ], -1)
    return torch.where(valid[..., None], dets, 0.0), valid
