"""Text as OpenCV 5.0 draws and measures it: ``cv2.putText`` and
``cv2.getTextSize`` for the Hershey face constants the JAX package passes.

OpenCV 5.0 no longer draws Hershey strokes: every ``FONT_HERSHEY_*`` face
names its built-in TrueType font, Rubik (``fonts/Rubik.ttf.gz``, SIL OFL 1.1;
its README gives the source), at a pixel size and a weight on Rubik's ``wght``
axis:

- the size is ``scale * 27`` rounded half up, in float32;
- the weight is 400 at ``thickness <= 1`` and 600 (``FONT_HERSHEY_SIMPLEX``)
  or 800 (``FONT_HERSHEY_COMPLEX``) above; ``DUPLEX`` and ``TRIPLEX`` are 600
  at ``thickness <= 1`` and 800 above. A thicker line does not make the text
  heavier past that;
- the line type and ``FONT_ITALIC`` change nothing.

The glyphs are rasterised and blended by ``csrc/truetype.cc`` (built with
the host ``g++`` into ``build/host/`` at first use; a failed build raises),
pixel for pixel as the installed cv2 5.0.0 does. A character outside Rubik's
cmap is drawn and measured as ``'?'``: cv2 draws it from a larger Unicode
face of its own, which the port does not carry. A newline is such a
character here; cv2 starts a new line at it. ``FONT_HERSHEY_PLAIN``,
``COMPLEX_SMALL`` and the ``SCRIPT`` faces, which no JAX call uses, raise
``ValueError``.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from yolov6_tpu_torch.data.native_aug import build_library, library_path

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "truetype.cc")
FONT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fonts", "Rubik.ttf.gz")

# cv2's constants
FONT_HERSHEY_SIMPLEX = 0
FONT_HERSHEY_DUPLEX = 2
FONT_HERSHEY_COMPLEX = 3
FONT_HERSHEY_TRIPLEX = 4
FONT_ITALIC = 16
LINE_8 = 8
LINE_AA = 16

_lib: Optional[ctypes.CDLL] = None
_font: Optional[int] = None
_lock = threading.Lock()


def load() -> Tuple[ctypes.CDLL, int]:
    """The library built from ``csrc/truetype.cc`` and the font opened in it."""
    global _lib, _font
    with _lock:
        if _lib is None:
            so = library_path(SOURCE)
            if not os.path.exists(so):
                build_library(SOURCE, so)
            lib = ctypes.CDLL(so)
            lib.yolov6_tt_open.restype = ctypes.c_void_p
            lib.yolov6_tt_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.yolov6_tt_text_size.restype = ctypes.c_int
            lib.yolov6_tt_text_size.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.yolov6_tt_put_text.restype = ctypes.c_int
            lib.yolov6_tt_put_text.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_long, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            with gzip.open(FONT, "rb") as f:
                data = f.read()
            font = lib.yolov6_tt_open(data, len(data))
            if not font:
                raise RuntimeError(f"{FONT}: not a TrueType font the text library can read")
            _lib, _font = lib, font
        return _lib, _font


def font_size(font_scale: float) -> int:
    """The pixel size cv2 5.0 gives a Hershey face's ``font_scale``."""
    size = int(np.floor(np.float32(font_scale) * np.float32(27) + np.float32(0.5)))
    if size < 0:
        raise ValueError(f"font scale {font_scale} is negative")
    return size


def font_weight(font_face: int, thickness: int) -> int:
    """The weight on Rubik's wght axis that cv2 5.0 gives a Hershey face at
    ``thickness`` (module doc)."""
    face = int(font_face) & ~FONT_ITALIC
    if face in (FONT_HERSHEY_DUPLEX, FONT_HERSHEY_TRIPLEX):
        return 600 if thickness <= 1 else 800
    if face in (FONT_HERSHEY_SIMPLEX, FONT_HERSHEY_COMPLEX):
        return 400 if thickness <= 1 else (600 if face == FONT_HERSHEY_SIMPLEX else 800)
    raise ValueError(f"font face {font_face}: only FONT_HERSHEY_SIMPLEX, DUPLEX, COMPLEX and "
                     "TRIPLEX are drawn")


def color3(color) -> Tuple[int, int, int]:
    """``color`` as cv2 turns a Scalar into a uint8 BGR pixel: each of its
    first three values rounded half to even and clipped to 0..255, missing
    ones 0."""
    vals = [color] if np.isscalar(color) else list(color)[:3]
    vals = [min(max(round(float(c)), 0), 255) for c in vals]
    return tuple(vals + [0] * (3 - len(vals)))


def check_image(img: np.ndarray, what: str) -> None:
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim == 3
            and img.shape[2] == 3 and img.flags.c_contiguous):
        raise ValueError(f"{what} draws on a C-contiguous HxWx3 uint8 image")


def _codepoints(text: str) -> np.ndarray:
    return np.array([ord(c) for c in str(text)], np.uint32)


def get_text_size(text: str, font_face: int, font_scale: float,
                  thickness: int) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize(text, font_face, font_scale, thickness)``:
    ``((w, h), baseline)``, the width 1 + the glyphs' advances, the height
    the pixel size, the baseline the lowest glyph's depth below it."""
    lib, font = load()
    cps = _codepoints(text)
    out = np.zeros(3, np.int32)
    if not lib.yolov6_tt_text_size(font, cps.ctypes.data, len(cps), font_size(font_scale),
                                   font_weight(font_face, thickness), out.ctypes.data):
        raise ValueError(f"{text!r}: a glyph of the font is broken")
    return (int(out[0]), int(out[1])), int(out[2])


def put_text(img: np.ndarray, text: str, org: Sequence[int], font_face: int,
             font_scale: float, color, thickness: int = 1, line_type: Optional[int] = None
             ) -> np.ndarray:
    """``cv2.putText(img, text, org, font_face, font_scale, color, thickness,
    line_type)`` on an HxWx3 uint8 image, in place: ``org`` is the baseline's
    left end; each glyph's coverage blends ``color`` into the pixels it
    touches, clipped at the borders. Returns ``img``."""
    del line_type  # cv2 5.0 ignores it
    check_image(img, "put_text")
    lib, font = load()
    cps = _codepoints(text)
    col = (ctypes.c_int * 3)(*color3(color))
    if not lib.yolov6_tt_put_text(font, img.ctypes.data, img.shape[0], img.shape[1], 3,
                                  img.strides[0], cps.ctypes.data, len(cps), int(org[0]),
                                  int(org[1]), font_size(font_scale),
                                  font_weight(font_face, thickness), col):
        raise ValueError(f"{text!r}: a glyph of the font is broken")
    return img
