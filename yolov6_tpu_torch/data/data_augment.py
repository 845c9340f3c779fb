"""Host-side image augmentations on HWC uint8 numpy images, without cv2
(port of yolov6_tpu/data/data_augment.py and of the cv2 calls it makes:
the two ``cv2.resize`` modes, 8-bit ``cvtColor`` between BGR/RGB and HSV,
and ``getRotationMatrix2D``).

``resize_linear`` follows cv2's INTER_LINEAR on uint8 bit for bit:
half-pixel centres, two taps a direction, coefficients in 11-bit fixed
point, the horizontal pass in integers and the vertical pass rounded as
cv2's SIMD path rounds it, each of its two products truncated on its own.
Horizontally an out-of-range tap is clamped with its weight (cv2's ``xofs``
table); vertically only the source row is clamped and the weights stay
split, so the first and last output rows of an enlargement round as cv2's
do. ``resize_area`` follows INTER_AREA: when shrinking, each output pixel
is the box-weighted mean of the source pixels its cell covers (cv2's area
table, non-integer factors included), rounded to nearest; when enlarging,
cv2's area-mode linear weights. tests/test_torch_letterbox.py holds both
against ``cv2.resize``.

The 8-bit HSV conversions are cv2's bit for bit (tests hold them against
cv2 over every input): BGR/RGB -> HSV in cv2's 12-bit fixed point, and HSV
-> BGR/RGB in float32 as cv2's code runs it, with its two fused
multiply-adds, truncated in the pixels cv2 converts 32 at a time and
rounded in the rest of each row (see ``hsv_to_rgb``).

The training augmentations (HSV jitter, mixup, the affine matrix and label
geometry, the mosaic placement) draw every random value from a
``Draws`` the caller passes in; the pixel passes of the mosaic, the warp and
the blend are in ``data/native_aug.py``.
"""

from __future__ import annotations

import math
import random
from typing import Tuple

import numpy as np

COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def _check(im: np.ndarray, dsize) -> Tuple[int, int]:
    if im.dtype != np.uint8 or im.ndim not in (2, 3):
        raise ValueError(f"need an HW or HWC uint8 image, got {im.dtype} {im.shape}")
    dw, dh = int(dsize[0]), int(dsize[1])
    if dw < 1 or dh < 1:
        raise ValueError(f"output size {dsize} is empty")
    return dw, dh


def _linear_taps(ssize: int, dsize: int, area_mode: bool = False, clamp_weights: bool = True):
    """Per output index: the two source indices and their fixed-point
    weights, as cv2 computes them (resize.cpp, the ``xofs``/``ialpha``
    tables, or with ``clamp_weights=False`` the ``yofs``/``ibeta`` tables,
    where only the source index is clamped). ``area_mode`` gives the weights
    INTER_AREA uses to enlarge."""
    inv_scale = dsize / ssize
    scale = 1.0 / inv_scale
    d = np.arange(dsize, dtype=np.float64)
    if area_mode:
        s0 = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s0 + 1) * inv_scale).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        fx = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s0 = np.floor(fx).astype(np.int64)
        f = fx - s0.astype(np.float32)
    if clamp_weights:
        low = s0 < 0
        f[low], s0[low] = 0, 0
        high = s0 >= ssize - 1
        f[high], s0[high] = 0, ssize - 1
    s1 = np.clip(s0 + 1, 0, ssize - 1)
    s0 = np.clip(s0, 0, ssize - 1)
    w0 = np.rint((np.float32(1) - f) * COEF_SCALE).astype(np.int64)
    w1 = np.rint(f * COEF_SCALE).astype(np.int64)
    return s0, s1, w0, w1


def _resize_linear_taps(im, dw, dh, area_mode):
    sh, sw = im.shape[:2]
    x0, x1, a0, a1 = _linear_taps(sw, dw, area_mode)
    y0, y1, b0, b1 = _linear_taps(sh, dh, area_mode, clamp_weights=False)
    shape = (1, -1) + (1,) * (im.ndim - 2)
    src = im.astype(np.int32)
    # horizontal pass in integers: each value is scaled by COEF_SCALE
    rows = src[:, x0] * a0.reshape(shape) + src[:, x1] * a1.reshape(shape)
    shape = (-1,) + (1,) * (im.ndim - 1)
    r0, r1 = rows[y0], rows[y1]
    b0, b1 = b0.reshape(shape), b1.reshape(shape)
    out = (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_linear(im: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(im, dsize, interpolation=cv2.INTER_LINEAR)`` on uint8;
    ``dsize`` is ``(w, h)``."""
    dw, dh = _check(im, dsize)
    if (dh, dw) == im.shape[:2]:
        return im.copy()
    return _resize_linear_taps(im, dw, dh, area_mode=False)


def _area_weights(ssize: int, dsize: int):
    """cv2's ``computeResizeAreaTab`` as padded tap tables: source indices
    ``[dsize, T]`` and weights ``[dsize, T]`` (0 on padding), for a shrink."""
    scale = ssize / dsize
    taps = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row.extend((sx, 1.0 / cell) for sx in range(sx1, sx2))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        taps.append(row)
    width = max(len(r) for r in taps)
    idx = np.zeros((dsize, width), np.int64)
    wts = np.zeros((dsize, width), np.float32)
    for d, row in enumerate(taps):
        for t, (s, a) in enumerate(row):
            idx[d, t], wts[d, t] = s, a
    return idx, wts


def resize_area(im: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(im, dsize, interpolation=cv2.INTER_AREA)`` on uint8;
    ``dsize`` is ``(w, h)``."""
    dw, dh = _check(im, dsize)
    sh, sw = im.shape[:2]
    if (dh, dw) == (sh, sw):
        return im.copy()
    if dw > sw or dh > sh:  # cv2 enlarges with area-mode linear weights in both directions
        return _resize_linear_taps(im, dw, dh, area_mode=True)
    if (sw, sh) == (2 * dw, 2 * dh):  # cv2's integer 2x2 path rounds halves up
        s = im.astype(np.int32).reshape((dh, 2, dw, 2) + im.shape[2:]).sum((1, 3))
        return ((s + 2) >> 2).astype(np.uint8)
    xi, xw = _area_weights(sw, dw)
    yi, yw = _area_weights(sh, dh)
    src = im.astype(np.float32)
    extra = (1,) * (im.ndim - 2)
    rows = (src[:, xi] * xw.reshape((1,) + xw.shape + extra)).sum(2)  # [sh, dw, ...]
    out = (rows[yi] * yw.reshape(yw.shape + (1,) + extra)).sum(1)  # [dh, dw, ...]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def letterbox(
    im: np.ndarray,
    new_shape=(640, 640),
    color=(114, 114, 114),
    auto: bool = True,
    scaleup: bool = True,
    stride: int = 32,
) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Aspect-preserving resize and constant pad (JAX:
    yolov6_tpu/data/data_augment.py:62-97, reference data_augment.py:29-58).

    Returns ``(image, ratio, (pad_left, pad_top))``, with the reference's 0.1
    nudges in the split of the padding."""
    shape = im.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    elif isinstance(new_shape, (list, tuple)) and len(new_shape) == 1:
        new_shape = (new_shape[0], new_shape[0])

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)

    new_unpad = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    dw /= 2
    dh /= 2

    if shape[::-1] != new_unpad:
        im = resize_linear(im, new_unpad)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    h, w = im.shape[:2]
    out = np.empty((h + top + bottom, w + left + right) + im.shape[2:], np.uint8)
    out[...] = np.asarray(color, np.uint8)[: im.shape[2]] if im.ndim == 3 else color[0]
    out[top:top + h, left:left + w] = im
    return out, r, (left, top)


# ------------------------------------------------------------------ random


class Draws:
    """The augmentations' random source: ``py``, a ``random.Random``, for the
    draws the JAX package makes with Python's ``random``, and ``np``, a
    ``numpy.random.RandomState``, for those it makes with ``np.random``; both
    seeded from ``seed``, so the same calls give the JAX package's values
    after ``random.seed(seed); np.random.seed(seed)``."""

    def __init__(self, seed: int):
        self.py = random.Random(seed)
        self.np = np.random.RandomState(seed)


def sample_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of sample ``index``'s draws in ``epoch``: the same whichever
    loader thread runs the sample."""
    return int(np.random.SeedSequence([seed, epoch, index]).generate_state(1)[0])


# --------------------------------------------------------------------- HSV

HSV_SHIFT = 12  # cv2's fixed point for RGB -> HSV on uint8
_I = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << HSV_SHIFT) / _I)]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << HSV_SHIFT) / (6.0 * _I))]).astype(np.int32)
# per hue sector, the (R, G, B) entries of [v, p, q, t] (cv2's sector_data
# read in RGB order)
_SECTORS = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0], [3, 1, 0], [0, 1, 2]])
_SIMD_PIXELS = 32  # cv2 converts HSV -> RGB 32 pixels at a time, then one by one


def rgb_to_hsv(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, cv2.COLOR_RGB2HSV)`` on HWC uint8 (H in [0, 180))."""
    r, g, b = (im[..., c].astype(np.int32) for c in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> HSV_SHIFT
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fma32(a, b, c):
    """float32 ``a·b + c`` rounded once, as a fused multiply-add: the
    float64 product of two float32 values is exact (checked over every HSV
    input against cv2)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` on HWC uint8 (H in [0, 180)).

    cv2 runs it in float32 with S and V scaled to [0, 1], ``1 - s·f`` and
    ``1 - s·(1 - f)`` as fused multiply-adds, and the result times 255
    truncated for the pixels its SIMD loop takes (the first multiple of 32
    of each row) and rounded for the rest of the row."""
    f32 = np.float32
    one = f32(1)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255)
    sector = np.floor(h)
    f = h - sector
    tab = np.stack([v, v * (one - s), v * _fma32(-s, f, one), v * _fma32(-s, one - f, one)], -1)
    rgb = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], -1) * f32(255)
    w = hsv.shape[1]
    simd = (np.arange(w) < w // _SIMD_PIXELS * _SIMD_PIXELS)[:, None]
    return np.clip(np.where(simd, np.floor(rgb), np.rint(rgb)), 0, 255).astype(np.uint8)


def _hsv_luts(gains):
    x = np.arange(0, 256, dtype=np.float64)
    return (((x * gains[0]) % 180).astype(np.uint8),
            np.clip(x * gains[1], 0, 255).astype(np.uint8),
            np.clip(x * gains[2], 0, 255).astype(np.uint8))


def augment_hsv_rgb(im: np.ndarray, gains) -> None:
    """In-place HSV jitter of an RGB image with drawn ``gains`` (JAX:
    data_augment.py:45-59): RGB -> HSV, a table a channel, HSV -> RGB.
    ``gains=None`` leaves the image as it is."""
    if gains is None:
        return
    hsv = rgb_to_hsv(im)
    for c, lut in enumerate(_hsv_luts(gains)):
        hsv[..., c] = lut[hsv[..., c]]
    im[...] = hsv_to_rgb(hsv)


def augment_hsv(im: np.ndarray, hgain=0.5, sgain=0.5, vgain=0.5, *, rng: Draws) -> None:
    """In-place HSV jitter of a BGR image, its gains drawn from ``rng.np``
    (JAX: data_augment.py:32-42)."""
    if not (hgain or sgain or vgain):
        return
    r = rng.np.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    rgb = np.ascontiguousarray(im[..., ::-1])
    augment_hsv_rgb(rgb, r)
    im[...] = rgb[..., ::-1]


# ------------------------------------------------------------ mixup, affine


def mixup(im, labels, im2, labels2, rng: Draws):
    """Beta(32, 32) blend of two images, written into ``im`` by the C++
    blend, and their labels (JAX: data_augment.py:100-104)."""
    from yolov6_tpu_torch.data.native_aug import blend  # native_aug imports this module

    blend(im, im2, rng.np.beta(32.0, 32.0))
    return im, np.concatenate((labels, labels2), 0)


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1, eps=1e-16):
    """Boxes that survive the affine transform (JAX: data_augment.py:107-112)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def rotation_matrix_2d(angle: float, center=(0.0, 0.0), scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: ``angle`` in
    degrees, counter-clockwise."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def get_transform_matrix(img_shape, new_shape, degrees, scale, shear, translate, rng: Draws):
    """Random rotation, scale, shear and translation, drawn from ``rng.py``
    in the JAX order (JAX: data_augment.py:115-136); returns ``(M, s)``."""
    new_height, new_width = new_shape
    C = np.eye(3)
    C[0, 2] = -img_shape[1] / 2
    C[1, 2] = -img_shape[0] / 2

    R = np.eye(3)
    a = rng.py.uniform(-degrees, degrees)
    s = rng.py.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix_2d(a, (0, 0), s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.py.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.py.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.py.uniform(0.5 - translate, 0.5 + translate) * new_width
    T[1, 2] = rng.py.uniform(0.5 - translate, 0.5 + translate) * new_height

    return T @ S @ R @ C, s


def affine_labels(labels, M, s, width, height):
    """The label half of the affine warp (JAX: data_augment.py:139-158):
    xyxy corners through ``M``, re-boxed, clipped and filtered by
    ``box_candidates``."""
    n = len(labels)
    if not n:
        return labels
    xy = np.ones((n * 4, 3))
    xy[:, :2] = labels[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
    xy = (xy @ M.T)[:, :2].reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
    keep = box_candidates(box1=labels[:, 1:5].T * s, box2=new.T, area_thr=0.1)
    labels = labels[keep]
    labels[:, 1:5] = new[keep]
    return labels


# ------------------------------------------------------------------ mosaic


def mosaic_placement(i, xc, yc, w, h, target_height, target_width):
    """Quadrant placement of mosaic image ``i`` (JAX: data_augment.py:174-192):
    ``(x1a, y1a, x2a, y2a, x1b, y1b, x2b, y2b)``, the canvas rectangle and the
    source crop it takes."""
    if i == 0:  # top left
        x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
        x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
    elif i == 1:  # top right
        x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, target_width * 2), yc
        x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
    elif i == 2:  # bottom left
        x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(target_height * 2, yc + h)
        x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
    else:  # bottom right
        x1a, y1a, x2a, y2a = xc, yc, min(xc + w, target_width * 2), min(target_height * 2, yc + h)
        x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
    return x1a, y1a, x2a, y2a, x1b, y1b, x2b, y2b


def mosaic_labels_shift(lb, w, h, padw, padh):
    """Normalised xywh labels -> absolute xyxy in the mosaic canvas (JAX:
    data_augment.py:195-205)."""
    lb = lb.copy()
    if lb.size:
        boxes = np.copy(lb[:, 1:])
        boxes[:, 0] = w * (lb[:, 1] - lb[:, 3] / 2) + padw
        boxes[:, 1] = h * (lb[:, 2] - lb[:, 4] / 2) + padh
        boxes[:, 2] = w * (lb[:, 1] + lb[:, 3] / 2) + padw
        boxes[:, 3] = h * (lb[:, 2] + lb[:, 4] / 2) + padh
        lb[:, 1:] = boxes
    return lb
