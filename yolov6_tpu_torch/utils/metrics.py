"""PR-curve metrics and the confusion matrix's counting (the port's own copy
of yolov6_tpu/utils/metrics.py:12-207; reference: yolov6/utils/metrics.py).
Used by the Evaler's ``do_pr_metric`` path. The plots (PR/F1 curves, the
confusion matrix) need matplotlib, which the port does not depend on, and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

_NO_PLOTS = "the PR/F1 and confusion-matrix plots need matplotlib and are not ported"


def compute_ap(recall: np.ndarray, precision: np.ndarray, method: str = "interp"):
    """AP from PR points (reference: metrics.py:77-102): 101-point interp or
    continuous area."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    if method == "interp":
        x = np.linspace(0, 1, 101)
        ap = np.trapezoid(np.interp(x, mrec, mpre), x)
    else:
        i = np.where(mrec[1:] != mrec[:-1])[0]
        ap = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, plot=False, save_dir=".", names=()):
    """Per-class AP + P/R/F1 at best-F1 confidence (reference: metrics.py:13-74).

    tp: [n_pred, n_iou_thrs] bool TP matrix; conf/pred_cls: [n_pred];
    target_cls: [n_gt]. Returns (p, r, ap, f1, unique_classes).
    ``plot=True`` raises: the curves need matplotlib, which the port does
    not depend on.
    """
    if plot:
        raise NotImplementedError(_NO_PLOTS)
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        mask = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = mask.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-px, -conf[mask], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-px, -conf[mask], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + 1e-16)
    i_best = f1_curve.mean(0).argmax()
    p, r, f1 = p_curve[:, i_best], r_curve[:, i_best], f1_curve[:, i_best]
    return p, r, ap, f1, unique_classes.astype(int)


def box_iou_np(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    a1 = np.prod(box1[:, 2:] - box1[:, :2], -1)
    a2 = np.prod(box2[:, 2:] - box2[:, :2], -1)
    return inter / (a1[:, None] + a2[None, :] - inter + 1e-16)


def process_batch(detections: np.ndarray, labels: np.ndarray, iouv: np.ndarray):
    """TP matrix at the 10 COCO IoU thresholds (reference: metrics.py:145-168).

    detections [N, 6] (xyxy conf cls); labels [M, 5] (cls xyxy).
    Returns bool [N, len(iouv)].
    """
    correct = np.zeros((detections.shape[0], iouv.shape[0]), bool)
    if labels.shape[0] == 0 or detections.shape[0] == 0:
        return correct
    iou = box_iou_np(labels[:, 1:], detections[:, :4])
    correct_class = labels[:, 0:1] == detections[None, :, 5]
    for ti, thr in enumerate(iouv):
        y, x = np.where((iou >= thr) & correct_class)
        if len(y):
            matches = np.stack([y, x, iou[y, x]], 1)
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), ti] = True
    return correct


class ConfusionMatrix:
    """(reference: metrics.py:170-258)"""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        if detections is None or len(detections) == 0:
            for gc in labels[:, 0].astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        iou = box_iou_np(labels[:, 1:], detections[:, :4]) if len(labels) else np.zeros((0, len(detections)))
        if len(labels):
            y, x = np.where(iou > self.iou_thres)
        else:
            y, x = np.array([], int), np.array([], int)
        if len(y):
            matches = np.stack([y, x, iou[y, x]], 1)
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = len(matches) > 0
        m0, m1, _ = matches.T.astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j][0]], gc] += 1  # correct/confused
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        for i, dc in enumerate(det_classes):
            if not (n and (m1 == i).any()):
                self.matrix[dc, self.nc] += 1  # background FP

    def print(self):
        for i in range(self.nc + 1):
            print(" ".join(map(str, self.matrix[i])))

    def plot(self, save_dir=".", names=()):
        raise NotImplementedError(_NO_PLOTS)
