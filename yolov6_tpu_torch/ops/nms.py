"""Fixed-shape batched NMS (port of yolov6_tpu/ops/nms.py:293-563).

Every step keeps static shapes, as in the JAX package:

  1. conf = obj * cls; multi-label candidates come from the [A, nc] score
     grid, below ``conf_thres`` zeroed.
  2. exact top-k to ``max_nms`` candidates, ties lowest index first (a
     stable descending sort, as ``lax.top_k`` orders them).
  3. class offset: boxes shifted by class * MAX_WH so one IoU geometry does
     per-class NMS.
  4. the greedy keep (ops/cuda/nms_kernel.py; the registered op
     ``yolov6::greedy_nms``, one node of an exported graph), chosen by
     ``method``:

     | method            | rule                    | CUDA tensor | CPU tensor |
     | ----------------- | ----------------------- | ----------- | ---------- |
     | None, ``'tiled'`` | emit once (JAX default) | the kernel  | plain loop |
     | ``'perclass'``    | emit once               | the kernel  | plain loop |
     | ``'pallas'``      | the Pallas rule         | the kernel  | plain loop |
     | ``'loop'``        | the Pallas rule         | plain loop  | plain loop |

     Under the default rule, as in the JAX package's default ``'tiled'``
     keep (``_tiled_keep`` + ``_emit_topk_kept``), every box is emitted at
     most once. Under the Pallas rule (``pallas_greedy_nms``, the JAX
     ``'loop'``), a kept box whose IoU with itself is not above the threshold
     (zero area, or inverted) fills every remaining row. The JAX package's
     ``'perclass'`` (a per-class Jacobi keep, its TPU parallelism lever)
     gives the keep set of ``'tiled'`` (yolov6_tpu/ops/nms.py:448-453): it
     falls back to ``_tiled_keep`` when a class holds more than
     ``class_cap`` candidates, when ``agnostic`` and when ``nc <= 1``, and
     otherwise resolves the same recurrence on the same class-offset boxes,
     where boxes of two classes never overlap while their coordinates lie in
     [0, MAX_WH). So here it is the default keep,
     and ``class_cap`` changes nothing.

Outputs are ``dets [b, max_det, 6]`` (xyxy, conf, cls) with invalid rows
zeroed, and ``valid [b, max_det]``. The JAX package's TPU levers
(approx_max_k, bf16 selection, the optimization barrier) are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from yolov6_tpu_torch.ops.boxes import xywh2xyxy
from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms_op, greedy_nms_plain

MAX_WH = 4096  # reference: utils/nms.py:54
# method -> (keep, emit_once); see the module doc. The selection hands the
# op its candidates sorted, the op's precondition.
_KEEPS = {
    None: (greedy_nms_op, True),
    "tiled": (greedy_nms_op, True),
    "perclass": (greedy_nms_op, True),
    "pallas": (greedy_nms_op, False),
    "loop": (greedy_nms_plain, False),
}


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
    class_cap: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched NMS over ``[b, A, 5+nc]`` predictions (JAX: nms.py:422-563).

    Returns ``(dets [b, max_det, 6] as xyxy/conf/cls, valid [b, max_det])``.
    ``class_mask`` is an optional [nc] 0/1 vector (the reference's
    ``classes`` filter). ``method`` picks the keep and its rule (module doc):
    None, ``'tiled'`` and ``'perclass'`` give the JAX package's default
    output, ``'pallas'`` and ``'loop'`` that of its ``'pallas'`` and
    ``'loop'`` keeps. ``class_cap`` (``'perclass'``'s bucket size in JAX)
    is taken for the JAX signature and changes no output."""
    if method not in _KEEPS:
        raise ValueError(f"unknown NMS method {method!r}")
    keep, emit_once = _KEEPS[method]
    candidates = _select_candidates(
        prediction.float(), conf_thres, max_nms, multi_label, agnostic, class_mask,
        anchor_topc, row_select,
    )
    return _keep_and_gather(candidates, keep, emit_once, max_det, iou_thres)


def _keep_and_gather(candidates, keep, emit_once: bool, max_det: int, iou_thres: float):
    """Run ``keep`` under the rule ``emit_once`` on the output of
    ``_select_candidates`` and gather ``(dets, valid)`` by its indices."""
    cand_boxes, nms_boxes, scores, cls_idx = candidates
    idx, valid = keep(nms_boxes.contiguous(), scores.contiguous(), max_det, float(iou_thres),
                      emit_once)
    idx = idx.long()
    dets = torch.cat([
        _gather_rows(cand_boxes, idx),
        _gather_rows(scores, idx)[..., None],
        _gather_rows(cls_idx, idx)[..., None],
    ], -1)
    return torch.where(valid[..., None], dets, 0.0), valid
