"""Synthetic detection dataset, written as PNG (the port's own copy of
yolov6_tpu/data/synth_detect.py).

Saturated shapes (circle, square, triangle, ring) on smooth noisy
backgrounds, in YOLO-txt format under ``images/{train,val}`` and
``labels/{train,val}``, with a ``data.json``. The random draws are the JAX
generator's, in the same order, so with the same seed and square images the
label rows are the same. The shapes are rasterised in numpy without cv2's
anti-aliasing, so the pixels are not the JAX generator's. ``sizes`` gives
the images other shapes than ``img_size`` square.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np

from yolov6_tpu_torch.data.image_io import imwrite_png

CLASS_NAMES = ["circle", "square", "triangle", "ring"]
# Saturated BGR fills, chosen to survive the default HSV jitter
_COLORS = [(40, 40, 230), (40, 200, 40), (230, 80, 40), (40, 210, 230)]


def _background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth random gradient + mild noise: textured but featureless."""
    lo = rng.integers(40, 120, 3)
    hi = rng.integers(120, 220, 3)
    gy = np.linspace(0, 1, h)[:, None, None]
    gx = np.linspace(0, 1, w)[None, :, None]
    t = gy * rng.uniform() + gx * (1 - rng.uniform())
    img = lo + (hi - lo) * np.clip(t, 0, 1)
    img = img + rng.normal(0, 8, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _draw_shape(img: np.ndarray, cls: int, cx: int, cy: int, r: int) -> tuple:
    """Fill one shape in place; returns its tight xyxy box in pixels."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = max(cx - r, 0), max(cy - r, 0), min(cx + r + 1, w), min(cy + r + 1, h)
    ys, xs = np.mgrid[y0:y1, x0:x1]
    dx, dy = xs - cx, ys - cy
    if cls == 0:  # circle
        mask = dx * dx + dy * dy <= r * r
    elif cls == 1:  # axis-aligned square
        mask = np.ones(dx.shape, bool)
    elif cls == 2:  # upright triangle, apex (cx, cy - r), base y = cy + r
        mask = (dy <= r) & (2 * np.abs(dx) <= dy + r)
    else:  # ring: a band of width th around radius r - th // 2
        th = max(2, r // 3)
        dist = np.sqrt(dx * dx + dy * dy)
        mask = np.abs(dist - (r - th // 2)) <= th / 2
    img[y0:y1, x0:x1][mask] = _COLORS[cls]
    return cx - r, cy - r, cx + r, cy + r


def _iou(a, b) -> float:
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def generate_split(img_dir: str, lb_dir: str, n: int, img_size: int, nc: int,
                   rng: np.random.Generator, prefix: str,
                   sizes: Optional[Sequence[Tuple[int, int]]] = None) -> None:
    """Write ``n`` images and label files; image i is ``sizes[i % len(sizes)]``
    (w, h), or ``img_size`` square."""
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lb_dir, exist_ok=True)
    for i in range(n):
        w, h = sizes[i % len(sizes)] if sizes else (img_size, img_size)
        side = min(w, h)
        img = _background(rng, h, w)
        boxes, rows = [], []
        for _ in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(0, nc))
            r = int(rng.uniform(0.10, 0.22) * side)
            cx = int(rng.uniform(r + 2, w - r - 2))
            cy = int(rng.uniform(r + 2, h - r - 2))
            box = (cx - r, cy - r, cx + r, cy + r)
            if any(_iou(box, b) > 0.15 for b in boxes):
                continue
            box = _draw_shape(img, cls, cx, cy, r)
            boxes.append(box)
            x0, y0, x1, y1 = (max(0, box[0]), max(0, box[1]), min(w, box[2]), min(h, box[3]))
            rows.append(
                f"{cls} {(x0 + x1) / 2 / w:.6f} {(y0 + y1) / 2 / h:.6f} "
                f"{(x1 - x0) / w:.6f} {(y1 - y0) / h:.6f}"
            )
        imwrite_png(osp.join(img_dir, f"{prefix}{i:05d}.png"), img)
        with open(osp.join(lb_dir, f"{prefix}{i:05d}.txt"), "w") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))


def generate_synth_dataset(root: str, n_train: int = 256, n_val: int = 64,
                           img_size: int = 320, nc: int = 4, seed: int = 0,
                           sizes: Optional[Sequence[Tuple[int, int]]] = None) -> str:
    """Write train/val splits and ``data.json`` under ``root``; returns the
    path of ``data.json``. ``sizes`` is a list of (w, h) image sizes, used in
    turn."""
    nc = min(nc, len(CLASS_NAMES))
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        generate_split(osp.join(root, "images", split), osp.join(root, "labels", split),
                       n, img_size, nc, rng, split, sizes)
    data_json = osp.join(root, "data.json")
    with open(data_json, "w") as f:
        json.dump({
            "train": osp.join(root, "images", "train"),
            "val": osp.join(root, "images", "val"),
            "nc": nc, "names": CLASS_NAMES[:nc], "is_coco": False,
        }, f)
    return data_json
