"""The eval path's resize and letterbox on HWC uint8 numpy images, without
cv2 (port of yolov6_tpu/data/data_augment.py:62-97 and of the two
``cv2.resize`` modes the JAX loader uses).

``resize_linear`` follows cv2's INTER_LINEAR on uint8: half-pixel centres,
two taps a direction with the edge clamped, coefficients in 11-bit fixed
point, the horizontal pass in integers and the vertical pass rounded as
cv2's SIMD path rounds it. ``resize_area`` follows INTER_AREA: when
shrinking, each output pixel is the box-weighted mean of the source pixels
its cell covers (cv2's area table, non-integer factors included), rounded
to nearest; when enlarging, cv2's area-mode linear weights. Both agree with
``cv2.resize`` within 1 per pixel (tests/test_torch_letterbox.py).

The training augmentations (HSV, mosaic, mixup, affine) come with the
trainer and are not here.
"""

from __future__ import annotations

import math
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


def _linear_taps(ssize: int, dsize: int, area_mode: bool = False):
    """Per output index: the two source indices and their fixed-point
    weights, as cv2 computes them (resize.cpp, the ``xofs``/``ialpha``
    tables). ``area_mode`` gives the weights INTER_AREA uses to enlarge."""
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
    low = s0 < 0
    f[low], s0[low] = 0, 0
    high = s0 >= ssize - 1
    f[high], s0[high] = 0, ssize - 1
    s1 = np.minimum(s0 + 1, ssize - 1)
    w0 = np.rint((np.float32(1) - f) * COEF_SCALE).astype(np.int64)
    w1 = np.rint(f * COEF_SCALE).astype(np.int64)
    return s0, s1, w0, w1


def _resize_linear_taps(im, dw, dh, area_mode):
    sh, sw = im.shape[:2]
    x0, x1, a0, a1 = _linear_taps(sw, dw, area_mode)
    y0, y1, b0, b1 = _linear_taps(sh, dh, area_mode)
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
