"""PR-curve metrics, the confusion matrix and their plots (the port's own
copy of yolov6_tpu/utils/metrics.py; reference: yolov6/utils/metrics.py).
Used by the Evaler's ``do_pr_metric`` path. The plots hand the same series,
colours, limits, legend strings and file names as the JAX package's to
``utils/plots.py``'s raster axes in place of matplotlib, which the machine
with the card lacks.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from yolov6_tpu_torch.utils.plots import Axes


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
    With plot=True writes PR_curve.png, F1_curve.png, P_curve.png and
    R_curve.png into save_dir (JAX: metrics.py:62-76).
    """
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    py = []
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        mask = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = mask.sum()
        if n_p == 0 or n_l == 0:
            # py stays aligned with unique_classes, so that the PR-curve
            # labels attach to the right curves
            if plot:
                py.append(np.zeros_like(px))
            continue
        fpc = (1 - tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-px, -conf[mask], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-px, -conf[mask], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if plot and j == 0:
                py.append(np.interp(px, mrec, mpre))

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + 1e-16)
    if plot:
        names_map = {int(c): (names[int(c)] if int(c) < len(names) else str(int(c)))
                     for c in unique_classes}
        plot_pr_curve(px, py, ap, osp.join(save_dir, "PR_curve.png"), names_map)
        plot_mc_curve(px, f1_curve, osp.join(save_dir, "F1_curve.png"), names_map, ylabel="F1")
        plot_mc_curve(px, p_curve, osp.join(save_dir, "P_curve.png"), names_map,
                      ylabel="Precision")
        plot_mc_curve(px, r_curve, osp.join(save_dir, "R_curve.png"), names_map, ylabel="Recall")
    i_best = f1_curve.mean(0).argmax()
    p, r, f1 = p_curve[:, i_best], r_curve[:, i_best], f1_curve[:, i_best]
    return p, r, ap, f1, unique_classes.astype(int)


def plot_pr_curve(px, py, ap, save_path, names):
    """PR curves per class and their mean (JAX: metrics.py:89-110): a
    coloured, labelled curve a class below 21 classes, grey ones without
    labels from 21 on."""
    ax = Axes()
    py = np.stack(py, axis=1) if py else np.zeros((len(px), 0))
    if 0 < py.shape[1] < 21:
        for i, c in enumerate(sorted(names)):
            if i < py.shape[1]:
                ax.plot(px, py[:, i], linewidth=1, label=f"{names[c]} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    if py.shape[1]:
        ax.plot(px, py.mean(1), linewidth=3, color="blue",
                label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend()
    ax.savefig(save_path)


def plot_mc_curve(px, py, save_path, names, xlabel="Confidence", ylabel="Metric"):
    """Metric-vs-confidence curves per class and their mean (JAX:
    metrics.py:113-130)."""
    ax = Axes()
    if 0 < len(py) < 21:
        for i, c in enumerate(sorted(names)):
            if i < len(py):
                ax.plot(px, py[i], linewidth=1, label=names[c])
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend()
    ax.savefig(save_path)


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
        """The column-normalised matrix as a Blues heatmap with a colorbar,
        ``confusion_matrix.png`` in ``save_dir`` (JAX: metrics.py:211-235):
        cells below 0.005 blank; up to 30 rows, each cell's value (black
        below 0.6, white from it) and, with a name a class, the names."""
        ax = Axes(box=(330, 70, 1700, 1290))
        m = self.matrix / (self.matrix.sum(0, keepdims=True) + 1e-6)
        m_disp = np.where(m < 0.005, np.nan, m)
        ax.imshow(m_disp, vmin=0.0, vmax=1.0)
        ax.colorbar()
        labels = list(names) + ["background"] if 0 < len(names) == self.nc else None
        n = self.nc + 1
        if labels and n <= 30:
            ax.set_xticks(range(n))
            ax.set_yticks(range(n))
            ax.set_xticklabels(labels)
            ax.set_yticklabels(labels)
        if n <= 30:
            for i in range(n):
                for j in range(n):
                    if np.isfinite(m_disp[i, j]):
                        ax.text(j, i, f"{m[i, j]:.2f}",
                                color="black" if m[i, j] < 0.6 else "white")
        ax.set_xlabel("True")
        ax.set_ylabel("Predicted")
        ax.savefig(osp.join(save_dir, "confusion_matrix.png"))
