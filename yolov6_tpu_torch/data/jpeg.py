"""JPEG decoding on the host, bit-equal to ``cv2.imread`` (the port's stand-in
for the libjpeg-turbo that cv2 carries; the machine with the card has no cv2).

``csrc/jpeg_decode.cc`` is compiled on first use with the host ``g++`` into
``build/host/`` (``native_aug.build_library``: the name carries a hash of
the source and the flags) and loaded with ctypes; a failed build raises, and
nothing falls back to another decoder. A ctypes call releases the GIL, so
loader threads decode in parallel.

It decodes baseline and extended sequential Huffman JPEG, 8-bit, grey or
three components (YCbCr, or RGB as libjpeg guesses it), through
libjpeg-turbo's default pipeline (accurate integer IDCT, fancy upsampling),
and applies the Exif orientation as ``cv2.imread`` does. Progressive,
lossless, hierarchical, arithmetic-coded, 12-bit and 4-component (CMYK/YCCK)
files, and truncated or corrupt ones, raise ``ValueError`` naming the file
and the kind.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from yolov6_tpu_torch.data.native_aug import build_library, library_path

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "jpeg_decode.cc")
_ERRLEN = 256

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The library built from ``csrc/jpeg_decode.cc``, compiled if needed."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path(SOURCE)
            if not os.path.exists(so):
                build_library(SOURCE, so)
            lib = ctypes.CDLL(so)
            c_int_p = ctypes.POINTER(ctypes.c_int)
            lib.yolov6_jpeg_info.restype = ctypes.c_int
            lib.yolov6_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, c_int_p, c_int_p,
                                             c_int_p, ctypes.c_char_p, ctypes.c_int]
            lib.yolov6_jpeg_decode.restype = ctypes.c_int
            lib.yolov6_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                                               ctypes.c_int]
            _lib = lib
        return _lib


def _error(path, err) -> ValueError:
    return ValueError(f"{path}: {err.value.decode(errors='replace')}")


def jpeg_size(data: bytes, path="<bytes>") -> Tuple[int, int, int]:
    """``(w, h, orientation)`` from the headers of the JPEG ``data``: the size
    as stored and the Exif orientation (1-8, 1 without one), as OpenCV reads
    it from the first APP1 segment."""
    w, h, orientation = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if load().yolov6_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                               ctypes.byref(orientation), err, _ERRLEN):
        raise _error(path, err)
    return w.value, h.value, orientation.value


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` under the Exif ``orientation`` as OpenCV's ``ExifTransform``
    applies it (transpose for 5-8, then the flips)."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flip = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1),) * 2,
            4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1),) * 2, 8: (slice(None, None, -1),)}.get(orientation)
    if flip:
        img = img[flip]
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, path="<bytes>") -> np.ndarray:
    """The JPEG ``data`` as ``cv2.imread`` returns it: HxWx3 uint8 BGR,
    C-contiguous, the Exif orientation applied. Raises ``ValueError`` naming
    ``path`` for a file it does not decode."""
    w, h, orientation = jpeg_size(data, path)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if load().yolov6_jpeg_decode(data, len(data), out.ctypes.data, w, h, err, _ERRLEN):
        raise _error(path, err)
    return orient(out, orientation)
