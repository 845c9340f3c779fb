"""The drawing the JAX package does with cv2 5.0, pixel for pixel: boxes,
circles, polygons and text on HxWx3 uint8 images, in place. The machine with
the card has no cv2.

- ``rectangle`` is ``cv2.rectangle``: at ``LINE_AA`` (the inferer's boxes and
  label backgrounds) cv2's anti-aliased thick polyline or convex fill, drawn by
  ``csrc/drawing.cc``; at ``LINE_8`` (the default) the integer box when
  ``thickness < 0``, else ``rectangle_line8``.
- ``circle`` and ``fill_poly`` are ``cv2.circle`` and ``cv2.fillPoly`` at
  ``LINE_AA``, as the synthetic dataset draws its shapes.
- ``rectangle_line8`` is ``cv2.rectangle`` at ``LINE_8``, in numpy (an outline
  of thickness 1, or cv2's thick polyline: bands of half-width
  ``(t + t % 2) // 2`` along the sides and a filled midpoint circle of radius
  ``(t + 1) // 2`` at each corner), as the trainer's plots and ``vis_dataset``
  call it.
- ``draw_text`` and ``plot_box_and_label`` write their text with
  ``utils/text.py``, the home of cv2 5.0's TrueType text and of the face and
  line-type constants.

``csrc/drawing.cc`` is built with the host ``g++`` into ``build/host/`` at
first use; a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from yolov6_tpu_torch.data.native_aug import build_library, library_path
from yolov6_tpu_torch.utils.text import (
    FONT_HERSHEY_COMPLEX,
    FONT_HERSHEY_SIMPLEX,
    LINE_8,
    LINE_AA,
    check_image,
    color3,
    get_text_size,
    put_text,
)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "drawing.cc")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The library built from ``csrc/drawing.cc``, compiled if needed."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path(SOURCE)
            if not os.path.exists(so):
                build_library(SOURCE, so)
            lib = ctypes.CDLL(so)
            head = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long,
                    ctypes.c_void_p]
            lib.yolov6_rectangle_aa.restype = None
            lib.yolov6_rectangle_aa.argtypes = head + [ctypes.c_int] * 5
            lib.yolov6_circle_aa.restype = None
            lib.yolov6_circle_aa.argtypes = head + [ctypes.c_int] * 4
            lib.yolov6_fill_poly_aa.restype = None
            lib.yolov6_fill_poly_aa.argtypes = head + [ctypes.c_void_p, ctypes.c_void_p,
                                                       ctypes.c_int]
            _lib = lib
        return _lib


def _head(img: np.ndarray, color, what: str) -> tuple:
    """The image and colour arguments of the library's functions."""
    check_image(img, what)
    col = (ctypes.c_int * 4)(*color3(color), 0)
    return img.ctypes.data, img.shape[0], img.shape[1], 3, img.strides[0], col


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1,
              line_type: int = LINE_8) -> np.ndarray:
    """``cv2.rectangle(img, p1, p2, color, thickness, line_type)`` (module
    doc); returns ``img``."""
    if line_type == LINE_AA:
        head = _head(img, color, "rectangle")
        load().yolov6_rectangle_aa(*head, int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1]),
                                    int(thickness))
        return img
    if line_type != LINE_8:
        raise ValueError(f"line type {line_type}: only LINE_8 and LINE_AA are drawn")
    if thickness >= 0:
        rectangle_line8(img, p1, p2, color, thickness)
        return img
    x1, x2 = sorted((int(p1[0]), int(p2[0])))
    y1, y2 = sorted((int(p1[1]), int(p2[1])))
    img[max(y1, 0):max(y2 + 1, 0), max(x1, 0):max(x2 + 1, 0)] = color3(color)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, thickness, cv2.LINE_AA)``:
    ellipse2Poly's polygon, filled when ``thickness < 0``, else its thick
    polyline; returns ``img``."""
    if radius < 0:
        raise ValueError(f"radius {radius} is negative")
    head = _head(img, color, "circle")
    load().yolov6_circle_aa(*head, int(center[0]), int(center[1]), int(radius),
                             int(thickness))
    return img


def fill_poly(img: np.ndarray, pts: Sequence, color) -> np.ndarray:
    """``cv2.fillPoly(img, pts, color, cv2.LINE_AA)`` for a list of contours
    (each an array of (x, y) integer points): the anti-aliased edges, then
    the even-odd fill between them; returns ``img``."""
    head = _head(img, color, "fill_poly")
    contours = [np.asarray(p).reshape(-1, 2) for p in pts]
    xy = np.ascontiguousarray(np.concatenate(contours) if contours else np.zeros((0, 2)),
                              np.int32)
    counts = np.array([len(c) for c in contours], np.int32)
    load().yolov6_fill_poly_aa(*head, xy.ctypes.data, counts.ctypes.data, len(contours))
    return img


def _circle_offsets(r: int):
    """The pixels of cv2's filled ``Circle`` of radius ``r`` (its midpoint
    walk), as ``(dy, dx)`` offsets."""
    pts = set()
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        for y, half in ((-dy, dx), (dy, dx), (-dx, dy), (dx, dy)):
            pts.update((y, x) for x in range(-half, half + 1))
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return sorted(pts)


def rectangle_line8(img: np.ndarray, p1, p2, color, thickness: int = 1) -> None:
    """``cv2.rectangle(img, p1, p2, color, thickness)`` at ``LINE_8`` (module
    doc), in place; pixels outside ``img`` are dropped."""
    x1, x2 = sorted((int(p1[0]), int(p2[0])))
    y1, y2 = sorted((int(p1[1]), int(p2[1])))
    H, W = img.shape[:2]

    def fill(ya, yb, xa, xb):
        ya, yb, xa, xb = max(ya, 0), min(yb, H - 1), max(xa, 0), min(xb, W - 1)
        if ya <= yb and xa <= xb:
            img[ya:yb + 1, xa:xb + 1] = color

    h = 0 if thickness <= 1 else (thickness + (thickness & 1)) // 2
    fill(y1 - h, y1 + h, x1, x2)
    fill(y2 - h, y2 + h, x1, x2)
    fill(y1, y2, x1 - h, x1 + h)
    fill(y1, y2, x2 - h, x2 + h)
    if thickness > 1:
        for dy, dx in _circle_offsets((thickness + 1) // 2):
            for cy, cx in ((y1, x1), (y1, x2), (y2, x1), (y2, x2)):
                if 0 <= cy + dy < H and 0 <= cx + dx < W:
                    img[cy + dy, cx + dx] = color


def draw_text(img, text, font=FONT_HERSHEY_SIMPLEX, pos=(0, 0), font_scale=1,
              font_thickness=2, text_color=(0, 255, 0), text_color_bg=(0, 0, 0)):
    """The JAX inferer's ``draw_text`` (yolov6_tpu/core/inferer.py:204-217):
    the text's box filled at ``LINE_8`` with a 5 px margin, the text over it."""
    offset = (5, 5)
    x, y = pos
    text_size, _ = get_text_size(text, font, font_scale, font_thickness)
    text_w, text_h = text_size
    rec_start = tuple(x - y for x, y in zip(pos, offset))
    rec_end = tuple(x + y for x, y in zip((x + text_w, y + text_h), offset))
    rectangle(img, rec_start, rec_end, text_color_bg, -1)
    put_text(img, text, (x, int(y + text_h + font_scale - 1)), font, font_scale, text_color,
             font_thickness, LINE_AA)
    return text_size


def plot_box_and_label(image, lw, box, label="", color=(128, 128, 128),
                       txt_color=(255, 255, 255), font=FONT_HERSHEY_COMPLEX):
    """The JAX inferer's ``plot_box_and_label`` (yolov6_tpu/core/inferer.py:
    219-229): the box's outline and the label's box at ``LINE_AA``; the label
    measured with ``FONT_HERSHEY_SIMPLEX`` and drawn with ``font``, both at
    ``max(lw - 1, 1)`` (so from lw 3 on the text is drawn a weight heavier
    than it was measured, as in the JAX package)."""
    p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
    rectangle(image, p1, p2, color, lw, LINE_AA)
    if label:
        tf = max(lw - 1, 1)
        w, h = get_text_size(label, FONT_HERSHEY_SIMPLEX, lw / 3, tf)[0]
        outside = p1[1] - h - 3 >= 0
        p2 = p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3
        rectangle(image, p1, p2, color, -1, LINE_AA)
        put_text(image, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2), font, lw / 3,
                 txt_color, tf, LINE_AA)
