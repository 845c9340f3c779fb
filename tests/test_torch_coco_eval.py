"""The port's COCO evaluator and PR metrics (yolov6_tpu_torch/utils/
{coco_eval,metrics}.py) against the JAX package's, and the eval geometry of
the port's loader, Evaler and evaluator with a mock detector (ported from
tests/test_eval_pipeline.py). Tolerance: the 12 COCO stats, per-class AP and
the PR metrics equal to 1e-12."""

import glob

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.utils.coco_eval import COCOEvaluator as JaxCOCOEvaluator
from yolov6_tpu.utils import metrics as jax_metrics

from yolov6_tpu_torch.core.evaler import Evaler
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.utils import metrics
from yolov6_tpu_torch.utils.coco_eval import COCOEvaluator
from yolov6_tpu_torch.utils.data_config import load_data_config

TOL = dict(rtol=0, atol=1e-12)


def _coco_case(seed):
    """GT with crowd boxes, small/medium/large areas, 3 categories, 2 images
    without GT; detections near the GT, spurious ones, and 130 on one image
    (above maxDets 100)."""
    rng = np.random.default_rng(seed)
    gt = {"images": [{"id": i} for i in range(8)], "categories": [{"id": c} for c in (0, 1, 2)],
          "annotations": []}
    dets, ann_id = [], 1
    for img in range(6):
        for _ in range(int(rng.integers(2, 7))):
            side = float(rng.choice([12.0, 50.0, 150.0]) * rng.uniform(0.8, 1.2))
            x, y = rng.uniform(0, 400, 2)
            box = [float(x), float(y), side, side * float(rng.uniform(0.6, 1.4))]
            cat = int(rng.integers(0, 3))
            gt["annotations"].append({"id": ann_id, "image_id": img, "category_id": cat,
                                      "bbox": box, "area": box[2] * box[3],
                                      "iscrowd": int(rng.uniform() < 0.15)})
            ann_id += 1
            for _ in range(int(rng.integers(0, 3))):
                jitter = rng.normal(0, 0.08 * side, 4)
                dets.append({"image_id": img, "category_id": cat, "score": float(rng.uniform()),
                             "bbox": [float(v) for v in np.asarray(box) + jitter]})
    for img in range(8):
        for _ in range(130 if img == 1 else int(rng.integers(0, 6))):
            x, y, w, h = rng.uniform(0, 400), rng.uniform(0, 400), *rng.uniform(5, 120, 2)
            dets.append({"image_id": img, "category_id": int(rng.integers(0, 3)),
                         "score": float(rng.uniform()), "bbox": [x, y, float(w), float(h)]})
    return gt, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_evaluator_matches_jax(seed):
    gt, dets = _coco_case(seed)
    ours, theirs = COCOEvaluator(gt), JaxCOCOEvaluator(gt)
    stats, stats_j = ours.evaluate(dets), theirs.evaluate(dets)
    assert list(stats) == list(stats_j) and len(stats) == 12
    np.testing.assert_allclose([stats[k] for k in stats], [stats_j[k] for k in stats], **TOL)
    assert 0 < stats["AP50"] < 1 and stats["AP_small"] > -1 and stats["AP_large"] > -1
    for (n, ap, ap50), (n_j, ap_j, ap50_j) in zip(ours.per_class_ap(), theirs.per_class_ap()):
        assert n == n_j
        np.testing.assert_allclose([ap, ap50], [ap_j, ap50_j], **TOL)


def test_pr_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    iouv = np.linspace(0.5, 0.95, 10)
    tps, confs, pcls, tcls = [], [], [], []
    cm, cm_j = metrics.ConfusionMatrix(nc=3), jax_metrics.ConfusionMatrix(nc=3)
    for _ in range(6):
        gt_xy = rng.uniform(0, 200, (5, 2))
        gt = np.concatenate([rng.integers(0, 3, (5, 1)), gt_xy, gt_xy + rng.uniform(10, 60, (5, 2))],
                            1).astype(np.float32)
        det_xy = np.concatenate([gt[:, 1:3], rng.uniform(0, 200, (4, 2))]) + rng.normal(0, 3, (9, 2))
        det = np.concatenate([det_xy, det_xy + rng.uniform(10, 60, (9, 2)), rng.uniform(0, 1, (9, 1)),
                              rng.integers(0, 3, (9, 1))], 1).astype(np.float32)
        correct = metrics.process_batch(det, gt, iouv)
        np.testing.assert_array_equal(correct, jax_metrics.process_batch(det, gt, iouv))
        cm.process_batch(det, gt)
        cm_j.process_batch(det, gt)
        tps.append(correct), confs.append(det[:, 4]), pcls.append(det[:, 5]), tcls.append(gt[:, 0])
    np.testing.assert_array_equal(cm.matrix, cm_j.matrix)
    args = [np.concatenate(x) for x in (tps, confs, pcls, tcls)]
    out, out_j = metrics.ap_per_class(*args), jax_metrics.ap_per_class(*args)
    for a, b in zip(out, out_j):
        np.testing.assert_allclose(a, b, **TOL)
    assert out[2].mean() > 0
    # the plots are written, and plotting changes no returned value
    from yolov6_tpu_torch.data.image_io import imread

    plotted = metrics.ap_per_class(*args, plot=True, save_dir=str(tmp_path), names=("a", "b", "c"))
    for a, b in zip(plotted, out):
        np.testing.assert_array_equal(a, b)
    cm.plot(save_dir=str(tmp_path), names=("a", "b", "c"))
    for name in ("PR_curve", "F1_curve", "P_curve", "R_curve", "confusion_matrix"):
        assert imread(str(tmp_path / f"{name}.png")).shape == (1500, 2250, 3), name


@pytest.fixture(scope="module")
def mock_set(tmp_path_factory):
    """Mixed sizes, so the letterbox pads, shrinks and enlarges."""
    root = tmp_path_factory.mktemp("mockset")
    data = load_data_config(generate_synth_dataset(
        str(root), n_train=0, n_val=6, img_size=320, seed=11,
        sizes=[(480, 640), (640, 480), (500, 500), (720, 405), (200, 150), (321, 241)]))
    return data


def _mock_rows(data, tmp_path, shift=0.0, rect=False):
    """COCO rows of a detector that emits every GT box, in letterbox pixels
    (shifted right by ``shift`` of its width), through the port's loader and
    ``convert_to_coco_format``; scored by ``eval_model``."""
    data = dict(data)
    evaler = Evaler(data, batch_size=4, img_size=320, save_dir=str(tmp_path), device="cpu",
                    infer_on_rect=rect)
    loader = evaler.init_data(None, "val")
    rows, shapes_seen = [], set()
    for imgs, labels, paths, shapes, n_valid in loader:
        b, h, w, _ = imgs.shape
        shapes_seen.add((h, w))
        dets = np.zeros((b, 300, 6), np.float32)
        valid = np.zeros((b, 300), bool)
        for i in range(b):
            lb = labels[i][labels[i][:, 0] >= 0]
            for j, (cls, cx, cy, bw, bh) in enumerate(lb):
                dx = shift * bw * w
                dets[i, j] = [(cx - bw / 2) * w + dx, (cy - bh / 2) * h,
                              (cx + bw / 2) * w + dx, (cy + bh / 2) * h, 0.9, cls]
                valid[i, j] = True
        rows.extend(evaler.convert_to_coco_format(dets[:n_valid], valid[:n_valid], paths, shapes))
    return rows, evaler.eval_model(rows, None, loader), shapes_seen


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_eval_pipeline_perfect_mock(mock_set, tmp_path, rect):
    rows, (ap50, ap), shapes = _mock_rows(mock_set, tmp_path, rect=rect)
    labels = glob.glob(mock_set["val"].replace("images", "labels") + "/*.txt")
    n_gt = sum(len(open(p).read().split()) // 5 for p in labels)
    assert len(rows) == n_gt > 0
    assert ap50 > 0.99, f"AP50={ap50}"
    assert ap > 0.95, f"AP={ap}"
    assert (len(shapes) > 1) == rect


def test_eval_pipeline_shifted_boxes_degrade(mock_set, tmp_path):
    """Shifting the mock's boxes by 10% of their width lowers strict-IoU AP
    and keeps AP50."""
    _, (ap50, ap), _ = _mock_rows(mock_set, tmp_path, shift=0.1)
    assert ap50 > 0.99
    assert ap < 0.95
