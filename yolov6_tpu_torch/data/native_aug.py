"""The training augmentation's pixel passes in C++ (port of
yolov6_tpu/data/native_aug.py and of the bindings in
yolov6_tpu/native/__init__.py).

``csrc/train_aug.cc`` is compiled on first use with the host ``g++`` into
``build/host/`` at the repository root (a git-ignored directory), under a
name that carries a hash of the source, its headers and the flags, and loaded with
ctypes; a failed build raises (``library_path`` and ``build_library`` build
``data/jpeg.py``'s decoder the same way). It does the mosaic compose, the
inverse-affine warp and the flips in one pass, the mixup blend, and the
non-mosaic branch's letterbox. Every random value is drawn here or by the caller from
a ``data_augment.Draws``, in the JAX package's order; the label geometry is
numpy (``data_augment.py``). ``train_aug_plain`` and ``blend_plain`` are
numpy versions of the warp and the blend, for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from yolov6_tpu_torch.data.data_augment import (
    Draws,
    affine_labels,
    get_transform_matrix,
    mosaic_labels_shift,
    mosaic_placement,
)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "train_aug.cc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "host")
# no contraction beyond the source's own std::fma calls, which -mfma makes
# instructions: float arithmetic rounds as the numpy versions' does
CXX_FLAGS = ("-O3", "-std=c++17", "-mfma", "-ffp-contract=off", "-fPIC", "-shared", "-Wall")
PAD = 114

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path(source: str) -> str:
    """Where the library built from the C++ file ``source`` lives: under
    ``build/host/``, named after the file and a hash of it, of the headers
    beside it that it includes (``#include "name"``), and of the flags."""
    with open(source, "rb") as f:
        text = f.read()
    for name in re.findall(rb'^#include "([^"]+)"', text, re.M):
        with open(os.path.join(os.path.dirname(source), name.decode()), "rb") as f:
            text += f.read()
    digest = hashlib.sha256(text + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build_library(source: str, so: str) -> None:
    """Compile ``source`` into the shared library ``so`` with ``$CXX`` or
    g++; raises ``RuntimeError`` when the compiler fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: put g++ on PATH or set CXX")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)


def lib_path() -> str:
    return library_path(SOURCE)


def _build(so: str) -> None:
    build_library(SOURCE, so)


def load() -> ctypes.CDLL:
    """The library built from ``csrc/train_aug.cc``, compiled if needed."""
    global _lib
    with _lock:
        if _lib is None:
            so = lib_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            lib.yolov6_train_aug.restype = ctypes.c_int
            lib.yolov6_train_aug.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_uint8,
            ]
            lib.yolov6_blend.restype = None
            lib.yolov6_blend.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                                         ctypes.c_double]
            lib.yolov6_letterbox.restype = ctypes.c_float
            lib.yolov6_letterbox.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_uint8, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            _lib = lib
        return _lib


def _check_image(im: np.ndarray, what: str) -> np.ndarray:
    if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f"{what}: need an HxWx3 uint8 image, got {im.dtype} {im.shape}")
    return np.ascontiguousarray(im)


def _check_place(srcs, place, minv):
    if not 1 <= len(srcs) <= 8:
        raise ValueError(f"need 1 to 8 source images, got {len(srcs)}")
    place = np.ascontiguousarray(place, np.int32)
    if place.shape != (len(srcs), 6):
        raise ValueError(f"place must be [{len(srcs)}, 6], got {place.shape}")
    for (x1a, y1a, x2a, y2a, x1b, y1b), s in zip(place.tolist(), srcs):
        if (x2a > x1a and y2a > y1a) and not (
                0 <= x1b and 0 <= y1b and x1b + x2a - x1a <= s.shape[1]
                and y1b + y2a - y1a <= s.shape[0]):
            raise ValueError(f"placement {(x1a, y1a, x2a, y2a, x1b, y1b)} reads outside its "
                             f"{s.shape[:2]} source")
    return place, np.ascontiguousarray(minv, np.float64).reshape(6)


def train_aug(srcs: Sequence[np.ndarray], place: np.ndarray, minv: np.ndarray,
              out_shape: Tuple[int, int], flip_lr: bool = False, flip_ud: bool = False,
              pad: int = PAD) -> np.ndarray:
    """Mosaic compose, inverse-affine warp and flips in one pass (C++).

    srcs: 1..8 HxWx3 uint8 images; place: int ``[n, 6]`` canvas placements
    ``(x1a, y1a, x2a, y2a, x1b, y1b)``; minv: the 6 entries of the inverse
    affine (output pixel -> canvas coordinates). Returns ``[out_h, out_w, 3]``
    uint8."""
    srcs = [_check_image(s, "train_aug") for s in srcs]
    place, minv = _check_place(srcs, place, minv)
    lib = load()
    ptrs = (ctypes.c_void_p * len(srcs))(*[s.ctypes.data for s in srcs])
    src_hw = np.array([s.shape[:2] for s in srcs], np.int32)
    out = np.empty((int(out_shape[0]), int(out_shape[1]), 3), np.uint8)
    rc = lib.yolov6_train_aug(ptrs, src_hw.ctypes.data, place.ctypes.data, len(srcs),
                              minv.ctypes.data, out.ctypes.data, out.shape[0], out.shape[1],
                              int(flip_lr), int(flip_ud), pad)
    if rc != 0:
        raise RuntimeError(f"yolov6_train_aug returned {rc}")
    return out


def blend(a: np.ndarray, b: np.ndarray, r: float) -> np.ndarray:
    """In-place mixup blend ``a = trunc(a·r + b·(1 − r))`` (C++); returns ``a``."""
    if a.shape != b.shape or a.dtype != np.uint8 or b.dtype != np.uint8:
        raise ValueError(f"blend needs two uint8 images of one shape, got {a.dtype} {a.shape} "
                         f"and {b.dtype} {b.shape}")
    if not a.flags.c_contiguous:
        raise ValueError("blend writes into a, which must be C-contiguous")
    b = np.ascontiguousarray(b)
    load().yolov6_blend(a.ctypes.data, b.ctypes.data, a.size, float(r))
    return a


def letterbox(im: np.ndarray, new_shape: Tuple[int, int], scaleup: bool = True,
              pad: int = PAD):
    """Aspect-keeping bilinear resize and constant pad (C++; the JAX package's
    ``letterbox_native``, which the non-mosaic train branch uses). Returns
    ``(image, ratio, (pad_left, pad_top))``."""
    im = _check_image(im, "letterbox")
    out = np.empty((int(new_shape[0]), int(new_shape[1]), 3), np.uint8)
    px, py = ctypes.c_int(0), ctypes.c_int(0)
    r = load().yolov6_letterbox(im.ctypes.data, im.shape[0], im.shape[1], out.ctypes.data,
                                out.shape[0], out.shape[1], int(scaleup), pad,
                                ctypes.byref(px), ctypes.byref(py))
    return out, float(r), (px.value, py.value)


# ------------------------------------------------------- the numpy oracles


def _fma32(a, b, c):
    """float32 ``a·b + c`` rounded once (``std::fma``): the float64 product
    of two float32 values is exact, and the sum of the interpolation's
    terms fits float64 but for coordinates within about 2e-7 of 0."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def train_aug_plain(srcs, place, minv, out_shape, flip_lr=False, flip_ud=False,
                    pad=PAD) -> np.ndarray:
    """numpy version of ``train_aug`` with the C++ pass's arithmetic: the
    canvas coordinates accumulated along each row in float64 from float32
    matrix entries, the bilinear taps as float32 fused multiply-adds, +0.5
    and truncated."""
    srcs = [_check_image(s, "train_aug_plain") for s in srcs]
    place, minv = _check_place(srcs, place, minv)
    out_h, out_w = int(out_shape[0]), int(out_shape[1])
    m = minv.astype(np.float32).astype(np.float64)
    ys = np.arange(out_h)
    if flip_ud:
        ys = ys[::-1]
    xs0 = out_w - 1 if flip_lr else 0
    dcx, dcy = (-m[0], -m[3]) if flip_lr else (m[0], m[3])
    start_x = m[0] * xs0 + (m[1] * ys + m[2])
    start_y = m[3] * xs0 + (m[4] * ys + m[5])
    steps_x = np.concatenate([[0.0], np.full(out_w - 1, dcx)])
    steps_y = np.concatenate([[0.0], np.full(out_w - 1, dcy)])
    # sequential sums along the row, as the C++ loop adds
    cx = np.add.accumulate(np.concatenate([start_x[:, None], np.broadcast_to(
        steps_x[1:], (out_h, out_w - 1))], 1), axis=1).astype(np.float32)
    cy = np.add.accumulate(np.concatenate([start_y[:, None], np.broadcast_to(
        steps_y[1:], (out_h, out_w - 1))], 1), axis=1).astype(np.float32)
    x0 = np.floor(cx).astype(np.int64)
    y0 = np.floor(cy).astype(np.int64)
    fx = (cx - x0.astype(np.float32))[..., None]
    fy = (cy - y0.astype(np.float32))[..., None]

    def canvas(ix, iy):
        """The virtual canvas at integer coordinates, the first region that
        covers a point winning (the C++ scan order)."""
        val = np.full(ix.shape + (3,), pad, np.uint8)
        done = np.zeros(ix.shape, bool)
        for (x1a, y1a, x2a, y2a, x1b, y1b), s in zip(place.tolist(), srcs):
            inside = ~done & (ix >= x1a) & (ix < x2a) & (iy >= y1a) & (iy < y2a)
            val[inside] = s[iy[inside] - (y1a - y1b), ix[inside] - (x1a - x1b)]
            done |= inside
        return val.astype(np.float32)

    p00, p01 = canvas(x0, y0), canvas(x0 + 1, y0)
    p10, p11 = canvas(x0, y0 + 1), canvas(x0 + 1, y0 + 1)
    fx, fy = np.broadcast_to(fx, p00.shape), np.broadcast_to(fy, p00.shape)
    v0 = _fma32(p01 - p00, fx, p00)
    v1 = _fma32(p11 - p10, fx, p10)
    return (_fma32(v1 - v0, fy, v0) + np.float32(0.5)).astype(np.uint8)


def blend_plain(a: np.ndarray, b: np.ndarray, r: float) -> np.ndarray:
    """numpy version of ``blend`` (JAX: data_augment.py:100-104), new array."""
    return (a * r + b * (1 - r)).astype(np.uint8)


# ------------------------------------------------------ draws and branches


def draw_hsv_gains(hyp: dict, rng: Draws) -> Optional[Tuple[float, float, float]]:
    """The HSV gains from ``rng.np`` (JAX: native_aug.py:41-50), or None when
    every gain is 0."""
    hgain, sgain, vgain = hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4)
    if not (hgain or sgain or vgain):
        return None
    r = rng.np.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    return float(r[0]), float(r[1]), float(r[2])


def draw_flips(hyp: dict, rng: Draws) -> Tuple[bool, bool]:
    """``(flip_lr, flip_ud)`` from ``rng.py``, flipud drawn first (JAX:
    native_aug.py:53-57)."""
    flip_ud = rng.py.random() < hyp.get("flipud", 0.0)
    flip_lr = rng.py.random() < hyp.get("fliplr", 0.5)
    return flip_lr, flip_ud


def mosaic_affine(imgs: List[np.ndarray], labels: List[np.ndarray], hyp: dict, rng: Draws,
                  target_height: int, target_width: int, flip_lr: bool = False,
                  flip_ud: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Four pre-resized images into a mosaic, warped by a random affine and
    flipped (JAX: native_aug.py:60-118). Labels in: normalised xywh; out:
    absolute xyxy, before the flips, which the caller applies to them."""
    if len(imgs) != 4:
        raise ValueError(f"a mosaic takes 4 images, got {len(imgs)}")
    yc = int(rng.py.uniform(target_height // 2, 3 * target_height // 2))
    xc = int(rng.py.uniform(target_width // 2, 3 * target_width // 2))
    place = np.zeros((4, 6), np.int32)
    shifted = []
    for i, (img, lb) in enumerate(zip(imgs, labels)):
        h, w = img.shape[:2]
        x1a, y1a, x2a, y2a, x1b, y1b, _, _ = mosaic_placement(
            i, xc, yc, w, h, target_height, target_width)
        place[i] = (x1a, y1a, x2a, y2a, x1b, y1b)
        shifted.append(mosaic_labels_shift(lb, w, h, x1a - x1b, y1a - y1b))
    labels4 = np.concatenate(shifted, 0)
    labels4[:, 1::2] = np.clip(labels4[:, 1::2], 0, 2 * target_width)
    labels4[:, 2::2] = np.clip(labels4[:, 2::2], 0, 2 * target_height)

    # the affine over the virtual 2x canvas
    M, s = get_transform_matrix((target_height * 2, target_width * 2),
                                (target_height, target_width), hyp["degrees"], hyp["scale"],
                                hyp["shear"], hyp["translate"], rng)
    minv = np.linalg.inv(M)[:2].reshape(6)
    img = train_aug(imgs, place, minv, (target_height, target_width), flip_lr, flip_ud)
    return img, affine_labels(labels4, M, s, target_width, target_height)


def affine(img: np.ndarray, labels: np.ndarray, degrees: float, translate: float, scale: float,
           shear: float, new_shape, rng: Draws, flip_lr: bool = False,
           flip_ud: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """The non-mosaic branch's random affine and flips (JAX: native_aug.py:121-141);
    ``labels`` are absolute xyxy with the class in column 0."""
    height, width = (new_shape, new_shape) if isinstance(new_shape, int) else new_shape
    M, s = get_transform_matrix(img.shape[:2], (height, width), degrees, scale, shear,
                                translate, rng)
    minv = np.linalg.inv(M)[:2].reshape(6)
    place = np.array([[0, 0, img.shape[1], img.shape[0], 0, 0]], np.int32)
    out = train_aug([img], place, minv, (height, width), flip_lr, flip_ud)
    return out, affine_labels(labels, M, s, width, height)
