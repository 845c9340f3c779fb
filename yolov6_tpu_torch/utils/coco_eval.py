"""COCO-protocol bbox evaluator in numpy (the port's own copy of
yolov6_tpu/utils/coco_eval.py:30-255; pycocotools is not a dependency).

The standard COCOeval bbox protocol: IoU thresholds 0.50:0.05:0.95,
101-point interpolated precision, the three area ranges, maxDets 1/10/100,
crowd handling. Inputs are a COCO-format ground-truth dict (or its path) and
a list of ``{image_id, category_id, bbox, score}`` detections, as the
reference feeds pycocotools (reference: yolov6/core/evaler.py:231-321).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """[D,4] x [G,4] xywh IoU; crowd GT uses intersection-over-det-area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


class COCOEvaluator:
    """COCO bbox evaluation over a GT dict + detection list."""

    def __init__(self, gt: Dict):
        if isinstance(gt, str):
            with open(gt) as f:
                gt = json.load(f)
        self.cat_ids = sorted(c["id"] for c in gt["categories"])
        self.img_ids = [im["id"] for im in gt["images"]]
        self._gt_by_key = defaultdict(list)
        for ann in gt["annotations"]:
            # ALL annotations are kept. pycocotools' bbox path has a known
            # quirk: _prepare normalizes gt['ignore'] then immediately
            # overwrites it with the iscrowd flag, so a user 'ignore' field
            # has NO effect — only iscrowd drives GT ignoring. Mirrored here
            # for strict protocol parity (see tests/cocoeval_oracle.py).
            self._gt_by_key[(ann["image_id"], ann["category_id"])].append(ann)

    def per_class_ap(self, names: Optional[Dict] = None):
        """[(name, AP, AP50)] after evaluate() (reference: evaler.py verbose
        per-class tables, :269-313)."""
        out = []
        for k, cat_id in enumerate(self.cat_ids):
            s = self.precision[:, :, k, 0, MAX_DETS.index(100)]
            s50 = self.precision[0, :, k, 0, MAX_DETS.index(100)]
            ap = float(s[s > -1].mean()) if (s > -1).any() else float("nan")
            ap50 = float(s50[s50 > -1].mean()) if (s50 > -1).any() else float("nan")
            name = names.get(cat_id, str(cat_id)) if names else str(cat_id)
            out.append((name, ap, ap50))
        return out

    def evaluate(self, detections: Sequence[Dict], verbose: bool = False) -> Dict[str, float]:
        det_by_key = defaultdict(list)
        for d in detections:
            det_by_key[(d["image_id"], d["category_id"])].append(d)

        T = len(IOU_THRS)
        R = len(REC_THRS)
        K = len(self.cat_ids)
        A = len(AREA_RNGS)
        M = len(MAX_DETS)
        # precision[T, R, K, A, M], recall[T, K, A, M]
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k, cat_id in enumerate(self.cat_ids):
            # per-image match results for this category, reused across area ranges
            per_img = []
            for img_id in self.img_ids:
                gts = self._gt_by_key.get((img_id, cat_id), [])
                dts = det_by_key.get((img_id, cat_id), [])
                if not gts and not dts:
                    continue
                dts = sorted(dts, key=lambda d: -d["score"])
                g_boxes = np.array([g["bbox"] for g in gts], float).reshape(-1, 4)
                d_boxes = np.array([d["bbox"] for d in dts], float).reshape(-1, 4)
                g_crowd = np.array([int(g.get("iscrowd", 0)) for g in gts], int)
                g_ign = g_crowd  # upstream quirk: ignore == iscrowd for bbox
                g_area = np.array(
                    [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts], float
                ).reshape(-1)
                d_area = d_boxes[:, 2] * d_boxes[:, 3]
                d_scores = np.array([d["score"] for d in dts], float)
                ious = _iou_xywh(d_boxes, g_boxes, g_crowd)
                per_img.append((g_crowd, g_ign, g_area, d_area, d_scores, ious))

            for a, (a_lo, a_hi) in enumerate(AREA_RNGS.values()):
                for m, max_det in enumerate(MAX_DETS):
                    evals = [
                        self._match_img(g_crowd, g_ign, g_area, d_area, d_scores, ious, a_lo, a_hi, max_det)
                        for (g_crowd, g_ign, g_area, d_area, d_scores, ious) in per_img
                    ]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    scores = np.concatenate([e[2] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    tps = np.concatenate([e[0] for e in evals], axis=1)[:, order]
                    ign = np.concatenate([e[1] for e in evals], axis=1)[:, order]
                    npig = sum(e[3] for e in evals)
                    if npig == 0:
                        continue
                    tp_cum = np.cumsum(tps & ~ign, axis=1).astype(float)
                    fp_cum = np.cumsum(~tps & ~ign, axis=1).astype(float)
                    for t in range(T):
                        tp, fp = tp_cum[t], fp_cum[t]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                        # precision envelope (monotone non-increasing from right)
                        pr = pr.copy()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        valid = inds < len(pr)
                        q[valid] = pr[inds[valid]]
                        precision[t, :, k, a, m] = q

        self.precision = precision
        self.recall = recall
        return self._summarize(verbose)

    @staticmethod
    def _match_img(g_crowd, g_ign, g_area, d_area, d_scores, ious, a_lo, a_hi, max_det):
        """Greedy per-image matching at all IoU thresholds.

        Returns (tps[T,D], ignore[T,D], scores[D], n_nonignored_gt) or None.
        """
        G = len(g_crowd)
        D = min(len(d_scores), max_det)
        g_ignore = (g_ign > 0) | (g_area < a_lo) | (g_area > a_hi)
        # sort gts: non-ignored first (stable) — pycocotools gtind
        g_order = np.argsort(g_ignore, kind="mergesort")
        g_ignore_s = g_ignore[g_order]
        g_crowd_s = g_crowd[g_order]
        ious_s = ious[:D][:, g_order] if G else np.zeros((D, 0))

        T = len(IOU_THRS)
        tps = np.zeros((T, D), bool)
        ign = np.zeros((T, D), bool)
        npig = int((~g_ignore).sum())
        if D == 0 and npig == 0:
            return None

        for t, thr in enumerate(IOU_THRS):
            gtm = -np.ones(G, int)
            for d in range(D):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for g in range(G):
                    if gtm[g] >= 0 and not g_crowd_s[g]:
                        continue
                    # dets go to non-ignored gts first; once we reach ignored
                    # gts with a match in hand, stop
                    if best_g > -1 and not g_ignore_s[best_g] and g_ignore_s[g]:
                        break
                    if ious_s[d, g] < best_iou:
                        continue
                    best_iou = ious_s[d, g]
                    best_g = g
                if best_g >= 0:
                    gtm[best_g] = d
                    tps[t, d] = True
                    ign[t, d] = g_ignore_s[best_g]
                else:
                    # unmatched det outside the area range is ignored
                    ign[t, d] = d_area[d] < a_lo or d_area[d] > a_hi
        return tps, ign, np.asarray(d_scores[:D]), npig

    def _summarize(self, verbose: bool = False) -> Dict[str, float]:
        def _avg(prec=True, iou=None, area="all", max_det=100):
            a = list(AREA_RNGS).index(area)
            m = MAX_DETS.index(max_det)
            if prec:
                s = self.precision[:, :, :, a, m]
                if iou is not None:
                    s = s[[int(round((iou - 0.5) / 0.05))]]
            else:
                s = self.recall[:, :, a, m]
                if iou is not None:
                    s = s[[int(round((iou - 0.5) / 0.05))]]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        stats = {
            "AP": _avg(),
            "AP50": _avg(iou=0.5),
            "AP75": _avg(iou=0.75),
            "AP_small": _avg(area="small"),
            "AP_medium": _avg(area="medium"),
            "AP_large": _avg(area="large"),
            "AR1": _avg(prec=False, max_det=1),
            "AR10": _avg(prec=False, max_det=10),
            "AR100": _avg(prec=False, max_det=100),
            "AR_small": _avg(prec=False, area="small"),
            "AR_medium": _avg(prec=False, area="medium"),
            "AR_large": _avg(prec=False, area="large"),
        }
        if verbose:
            names = [
                ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", "AP"),
                ("Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ]", "AP50"),
                ("Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ]", "AP75"),
                ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", "AP_small"),
                ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", "AP_medium"),
                ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", "AP_large"),
                ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ]", "AR1"),
                ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ]", "AR10"),
                ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", "AR100"),
                ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", "AR_small"),
                ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", "AR_medium"),
                ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", "AR_large"),
            ]
            for label, key in names:
                print(f" {label} = {stats[key]:.3f}")
        return stats


def coco80_to_coco91_class() -> List[int]:
    """80-class contiguous ids -> COCO paper 91-id space
    (reference: core/evaler.py:432-439)."""
    return [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
        21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
        41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
        59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
        80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
    ]
