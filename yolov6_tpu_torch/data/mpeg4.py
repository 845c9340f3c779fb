"""MPEG-4 Part 2 video on the host (ctypes over ``csrc/mpeg4_video.cc``).

``Mpeg4Decoder`` decodes the samples of an ``mp4v`` track (the Simple and
Advanced Simple subset that FFmpeg's ``mpeg4`` encoder writes for OpenCV's
``VideoWriter``) into YUV 4:2:0 planes, bit-exact with the FFmpeg decoder
that OpenCV's FFmpeg backend runs; ``encode_headers`` and ``encode_vop``
write an intra-only stream at a fixed quantiser. The library is compiled
on first use with the host ``g++`` into ``build/host/`` (as the JPEG codec
is) and a failed build raises. A feature outside the subset (B-VOPs, GMC,
quarter-pel, interlacing, data partitioning, a non-rectangular shape,
not_8_bit, the studio profiles) raises ``ValueError`` naming it.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from yolov6_tpu_torch.data.jpeg import _open

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "mpeg4_video.cc")
_ERRLEN = 256
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The library built from ``csrc/mpeg4_video.cc``, compiled if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _open(SOURCE)
            c_int_p = ctypes.POINTER(ctypes.c_int)
            lib.yolov6_m4v_open.restype = ctypes.c_void_p
            lib.yolov6_m4v_open.argtypes = []
            lib.yolov6_m4v_close.restype = None
            lib.yolov6_m4v_close.argtypes = [ctypes.c_void_p]
            lib.yolov6_m4v_config.restype = ctypes.c_int
            lib.yolov6_m4v_config.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                              c_int_p, c_int_p, ctypes.c_char_p, ctypes.c_int]
            lib.yolov6_m4v_decode.restype = ctypes.c_int
            lib.yolov6_m4v_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, c_int_p, c_int_p, c_int_p,
                ctypes.c_char_p, ctypes.c_int]
            lib.yolov6_m4v_picture.restype = None
            lib.yolov6_m4v_picture.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                               ctypes.c_void_p, ctypes.c_void_p]
            lib.yolov6_m4v_encode_headers.restype = ctypes.c_int
            lib.yolov6_m4v_encode_headers.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                      ctypes.c_void_p, ctypes.c_int]
            lib.yolov6_m4v_encode_vop.restype = ctypes.c_int
            lib.yolov6_m4v_encode_vop.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64]
            lib.yolov6_yuv_to_bgr.restype = None
            lib.yolov6_yuv_to_bgr.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p, ctypes.c_void_p]
            lib.yolov6_bgr_to_yuv420.restype = None
            lib.yolov6_bgr_to_yuv420.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_void_p, ctypes.c_void_p,
                                                 ctypes.c_void_p]
            _lib = lib
        return _lib


def chroma_size(width: int, height: int) -> Tuple[int, int]:
    return (width + 1) // 2, (height + 1) // 2


class Mpeg4Decoder:
    """A decoder's state across the samples of one stream. ``config`` is the
    decoder configuration from the container (the VOL headers), if any."""

    def __init__(self, config: bytes = b"", name: str = "<stream>"):
        self.name = name
        self._lib = load()
        self._h = self._lib.yolov6_m4v_open()
        if not self._h:
            raise MemoryError("could not allocate the MPEG-4 decoder")
        self.width = self.height = 0
        if config:
            w, h = ctypes.c_int(), ctypes.c_int()
            err = ctypes.create_string_buffer(_ERRLEN)
            if self._lib.yolov6_m4v_config(self._h, config, len(config), ctypes.byref(w),
                                           ctypes.byref(h), err, _ERRLEN):
                raise self._error(err)
            self.width, self.height = w.value, h.value

    def _error(self, err) -> ValueError:
        return ValueError(f"{self.name}: {err.value.decode(errors='replace')}")

    def decode(self, sample: bytes):
        """The picture of one sample as (y, u, v) uint8 planes, or None for a
        sample without a coded VOP."""
        if not self._h:
            raise ValueError(f"{self.name}: the decoder is closed")
        got, w, h = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = ctypes.create_string_buffer(_ERRLEN)
        if self._lib.yolov6_m4v_decode(self._h, sample, len(sample), ctypes.byref(got),
                                       ctypes.byref(w), ctypes.byref(h), err, _ERRLEN):
            raise self._error(err)
        self.width, self.height = w.value, h.value
        if not got.value:
            return None
        cw, ch = chroma_size(w.value, h.value)
        y = np.empty((h.value, w.value), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        self._lib.yolov6_m4v_picture(self._h, y.ctypes.data, u.ctypes.data, v.ctypes.data)
        return y, u, v

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.yolov6_m4v_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def encode_headers(width: int, height: int, tinc_res: int) -> bytes:
    """VOS + VO + VOL of the encoder's stream (the ``esds`` configuration)."""
    out = ctypes.create_string_buffer(64)
    n = load().yolov6_m4v_encode_headers(width, height, tinc_res, out, 64)
    if n < 0:
        raise RuntimeError("MPEG-4 headers longer than 64 bytes")
    return out.raw[:n]


def encode_vop(y: np.ndarray, u: np.ndarray, v: np.ndarray, q: int, tinc_res: int, t: int,
               secs: int) -> bytes:
    """An I-VOP of the 4:2:0 planes at quantiser ``q`` and time index ``t``
    (``tinc_res`` a second), ``secs`` whole seconds after the previous VOP."""
    h, w = y.shape
    cw, ch = chroma_size(w, h)
    if u.shape != (ch, cw) or v.shape != (ch, cw):
        raise ValueError(f"chroma planes {u.shape}, {v.shape} for a {w}x{h} picture")
    if not 1 <= q <= 31:
        raise ValueError(f"quantiser {q} outside 1-31")
    planes = [np.ascontiguousarray(p, dtype=np.uint8) for p in (y, u, v)]
    cap = 64 + w * h * 8
    out = np.empty(cap, np.uint8)
    n = load().yolov6_m4v_encode_vop(planes[0].ctypes.data, planes[1].ctypes.data,
                                     planes[2].ctypes.data, w, h, q, tinc_res, t, secs,
                                     out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"MPEG-4 encoder failed ({n})")
    return out[:n].tobytes()
