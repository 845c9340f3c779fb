"""JPEG decoding and encoding on the host, bit-equal to ``cv2.imread`` and
``cv2.imencode('.jpg')`` (the port's stand-in for the libjpeg-turbo that cv2
carries; the machine with the card has no cv2).

``csrc/jpeg_decode.cc`` and ``csrc/jpeg_encode.cc`` are compiled on first
use with the host ``g++`` into ``build/host/`` (``native_aug.build_library``:
the name carries a hash of the source, its headers and the flags) and loaded with ctypes;
a failed build raises, and nothing falls back to another codec. A ctypes
call releases the GIL, so loader threads decode in parallel.

The decoder takes sequential and progressive Huffman JPEG, 8-bit, grey,
three components (YCbCr, or RGB as libjpeg guesses it) or four (CMYK, or
YCCK under Adobe transform 2, turned into BGR as OpenCV turns CMYK), through
libjpeg-turbo's default pipeline (accurate integer IDCT, fancy upsampling),
and applies the Exif orientation as ``cv2.imread`` does. A file that ends
early decodes as cv2 decodes it (the blocks past the end grey; a progressive
file's missing low-frequency bits block-smoothed as libjpeg-turbo 3 fills
them), with a warning logged. Lossless, hierarchical, arithmetic-coded and
12-bit files, corrupt ones and a file that ends before its first scan
raise ``ValueError`` naming the file and the kind.

``decode_jpeg_scaled`` decodes to RGB at DCT scale 1/2, 1/4 or 1/8 as
libjpeg does at ``scale_denom``, and ``bilinear_resize`` is the JAX native
library's float resize: together the JAX package's train-path JPEG read
(``read_jpeg_train``).

``encode_jpeg`` writes baseline JPEG as libjpeg-turbo's defaults write it:
at ``quality=95, subsampling="420"`` the bytes of ``cv2.imencode('.jpg',
img)``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional, Tuple

import numpy as np

from yolov6_tpu_torch.data.native_aug import build_library, library_path

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "jpeg_decode.cc")
ENCODER_SOURCE = os.path.join(os.path.dirname(SOURCE), "jpeg_encode.cc")
_ERRLEN = 256
LOGGER = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_enc: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
SUBSAMPLINGS = {"444": 0, "420": 1}


def _open(source: str) -> ctypes.CDLL:
    so = library_path(source)
    if not os.path.exists(so):
        build_library(source, so)
    return ctypes.CDLL(so)


def load() -> ctypes.CDLL:
    """The library built from ``csrc/jpeg_decode.cc``, compiled if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _open(SOURCE)
            c_int_p = ctypes.POINTER(ctypes.c_int)
            lib.yolov6_jpeg_info.restype = ctypes.c_int
            lib.yolov6_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, c_int_p, c_int_p,
                                             c_int_p, c_int_p, ctypes.c_char_p, ctypes.c_int]
            lib.yolov6_jpeg_decode_as.restype = ctypes.c_int
            lib.yolov6_jpeg_decode_as.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, c_int_p, ctypes.c_char_p, ctypes.c_int]
            lib.yolov6_jpeg_decode_cmyk.restype = ctypes.c_int
            lib.yolov6_jpeg_decode_cmyk.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                c_int_p, ctypes.c_char_p, ctypes.c_int]
            lib.yolov6_jpeg_decode_scaled.restype = ctypes.c_int
            lib.yolov6_jpeg_decode_scaled.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, c_int_p, ctypes.c_char_p, ctypes.c_int]
            lib.yolov6_bilinear_resize.restype = None
            lib.yolov6_bilinear_resize.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int]
            lib.yolov6_jpeg_decode_planes.restype = ctypes.c_int
            lib.yolov6_jpeg_decode_planes.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                c_int_p, c_int_p, c_int_p, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


class NotRGBError(ValueError):
    """The file is one that libjpeg reads but converts to no RGB (CMYK,
    YCCK), or is not a JPEG at all."""


_NOT_RGB = 5  # the C library's code for NotRGBError


def _error(path, err, code=0) -> ValueError:
    return (NotRGBError if code == _NOT_RGB else ValueError)(
        f"{path}: {err.value.decode(errors='replace')}")


def jpeg_info(data: bytes, path="<bytes>") -> Tuple[int, int, int, int]:
    """``(w, h, orientation, components)`` from the headers of the JPEG
    ``data``: the size as stored, the Exif orientation (1-8, 1 without one),
    as OpenCV reads it from the first APP1 segment, and the frame's number
    of components (1 for grey)."""
    w, h, orientation, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if load().yolov6_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                               ctypes.byref(orientation), ctypes.byref(nc), err, _ERRLEN):
        raise _error(path, err)
    return w.value, h.value, orientation.value, nc.value


def jpeg_size(data: bytes, path="<bytes>") -> Tuple[int, int, int]:
    """``(w, h, orientation)`` of ``jpeg_info``."""
    return jpeg_info(data, path)[:3]


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


def _decode(data: bytes, path, force_color: int) -> Tuple[np.ndarray, int]:
    w, h, orientation = jpeg_size(data, path)
    out = np.empty((h, w, 3), np.uint8)
    truncated = ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if load().yolov6_jpeg_decode_as(data, len(data), out.ctypes.data, w, h, force_color,
                                    ctypes.byref(truncated), err, _ERRLEN):
        raise _error(path, err)
    if truncated.value:
        LOGGER.warning(f"{path}: premature end of JPEG file; the missing blocks are grey "
                       "(128), as cv2.imread returns them")
    return out, orientation


def decode_jpeg(data: bytes, path="<bytes>") -> np.ndarray:
    """The JPEG ``data`` as ``cv2.imread`` returns it: HxWx3 uint8 BGR,
    C-contiguous, the Exif orientation applied. Raises ``ValueError`` naming
    ``path`` for a file it does not decode."""
    out, orientation = _decode(data, path, -1)
    return orient(out, orientation)


COLOR_MODES = {"none": 0, "ycbcr": 1}


def decode_jpeg_as(data: bytes, path="<bytes>", color: str = "ycbcr") -> np.ndarray:
    """The JPEG stream ``data`` decoded as libtiff decodes a strip of a
    JPEG-compressed TIFF: HxWx3 uint8 BGR, no Exif orientation, the colour
    space set by the TIFF, not guessed: ``"ycbcr"`` (YCbCr, or YCCK) or
    ``"none"`` (the components as stored: RGB, CMYK)."""
    return _decode(data, path, COLOR_MODES[color])[0]


def decode_jpeg_planes(data: bytes, path="<bytes>") -> list:
    """A JPEG (a Motion JPEG frame) as FFmpeg's MJPEG decoder reconstructs
    it, before any colour conversion: its components' planes, each uint8
    at its own sampled size ([Y] or [Y, Cb, Cr]; full range, "yuvj"), through
    libavcodec's simple IDCT rather than libjpeg's. No orientation."""
    w, h, _ = jpeg_size(data, path)
    out = np.empty(w * h * 3, np.uint8)
    ncomp, truncated = ctypes.c_int(), ctypes.c_int()
    dims = (ctypes.c_int * 6)()
    err = ctypes.create_string_buffer(_ERRLEN)
    if load().yolov6_jpeg_decode_planes(data, len(data), out.ctypes.data, w, h,
                                        ctypes.byref(ncomp), dims, ctypes.byref(truncated), err,
                                        _ERRLEN):
        raise _error(path, err)
    planes, off = [], 0
    for i in range(ncomp.value):
        pw, ph = dims[2 * i], dims[2 * i + 1]
        planes.append(out[off:off + pw * ph].reshape(ph, pw))
        off += pw * ph
    return planes


def decode_jpeg_scaled(data: bytes, denom: int, path="<bytes>") -> np.ndarray:
    """The JPEG ``data`` as libjpeg decodes it to RGB at DCT scale
    ``1/denom`` (``scale_denom``, 1, 2, 4 or 8; the JAX package's native
    train-path read): ``ceil(h / denom) x ceil(w / denom) x 3`` uint8 RGB,
    C-contiguous, no Exif orientation, grey as RGB. At 1/2, 1/4 and 1/8
    that is jidctred.c's reduced IDCTs, chroma decoded larger in place of
    upsampling where its sampling allows, and no fancy upsampling at 1/8.
    Raises ``NotRGBError`` for a CMYK or YCCK file, which libjpeg does not
    convert to RGB, and for data that is not a JPEG; ``ValueError`` for
    what ``decode_jpeg`` refuses."""
    if denom not in (1, 2, 4, 8):
        raise ValueError(f"denom={denom}: one of 1, 2, 4 and 8")
    if data[:2] != b"\xff\xd8":
        raise NotRGBError(f"{path}: not a JPEG file (no SOI)")
    w, h, _, components = jpeg_info(data, path)
    if components == 4:
        raise NotRGBError(f"{path}: 4-component (CMYK or YCCK) JPEG: libjpeg converts it to "
                          "no RGB")
    out = np.empty((-(-h // denom), -(-w // denom), 3), np.uint8)
    truncated = ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = load().yolov6_jpeg_decode_scaled(data, len(data), denom, out.ctypes.data, out.shape[1],
                                          out.shape[0], ctypes.byref(truncated), err, _ERRLEN)
    if rc:
        raise _error(path, err, rc)
    if truncated.value:
        LOGGER.warning(f"{path}: premature end of JPEG file; the missing blocks are grey "
                       "(128), as libjpeg returns them")
    return out


def bilinear_resize(img: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    """HxWx3 uint8 ``img`` resized to ``dst_h x dst_w`` as the JAX package's
    native train path resizes a decoded JPEG (``native/dataload.cc``
    ``BilinearResize``: float32, half-pixel centres, rounded half away
    from zero), bit for bit."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"bilinear_resize needs HxWx3, got {img.shape}")
    out = np.empty((dst_h, dst_w, 3), np.uint8)
    load().yolov6_bilinear_resize(img.ctypes.data, img.shape[0], img.shape[1], out.ctypes.data,
                                  dst_h, dst_w)
    return out


def train_denom(h0: int, w0: int, target: int) -> int:
    """The DCT scale's denominator of the JAX package's train-path read
    (datasets.py ``_load_image_rgb``): the largest of 1, 2, 4 and 8 that
    keeps ``max(h0, w0) / denom`` at ``target`` or above."""
    denom = 1
    for n in (2, 4, 8):
        if max(h0, w0) / n >= target:
            denom = n
    return denom


def read_jpeg_train(path: str, denom: int, dst_h: int, dst_w: int) -> Optional[np.ndarray]:
    """The JPEG file at ``path`` read as the JAX package's native train path
    reads it (``native.decode_jpeg_resize_native``): decoded at DCT scale
    ``1/denom`` (``decode_jpeg_scaled``), then resized to ``dst_h x dst_w``
    by ``bilinear_resize`` unless it has that size already; RGB uint8.
    One departure: an Exif orientation is applied before the resize, as
    ``cv2.imread`` applies it, where the JAX library decodes the stored
    pixels into the oriented size. Returns None where libjpeg would refuse
    the file (``NotRGBError``: CMYK, YCCK, not a JPEG), for the caller's
    fallback; raises ``ValueError`` for the files ``decode_jpeg`` refuses."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        im = decode_jpeg_scaled(data, denom, path)
    except NotRGBError:
        return None
    orientation = jpeg_info(data, path)[2]
    if orientation != 1:
        im = orient(im, orientation)
    if im.shape[:2] != (dst_h, dst_w):
        im = bilinear_resize(im, dst_h, dst_w)
    return im


def decode_jpeg_cmyk(data: bytes, path="<bytes>") -> np.ndarray:
    """A 4-component JPEG as libjpeg's CMYK output gives it (YCCK
    converted): HxWx4 uint8, C-contiguous, no orientation."""
    w, h, _ = jpeg_size(data, path)
    out = np.empty((h, w, 4), np.uint8)
    truncated = ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if load().yolov6_jpeg_decode_cmyk(data, len(data), out.ctypes.data, w, h,
                                      ctypes.byref(truncated), err, _ERRLEN):
        raise _error(path, err)
    return out



def load_encoder() -> ctypes.CDLL:
    """The library built from ``csrc/jpeg_encode.cc``, compiled if needed."""
    global _enc
    with _lock:
        if _enc is None:
            lib = _open(ENCODER_SOURCE)
            lib.yolov6_jpeg_encode_bound.restype = ctypes.c_size_t
            lib.yolov6_jpeg_encode_bound.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.yolov6_jpeg_encode.restype = ctypes.c_int
            lib.yolov6_jpeg_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int]
            _enc = lib
        return _enc


def encode_jpeg(img: np.ndarray, quality: int = 95, subsampling: str = "420") -> bytes:
    """``img`` (HW or HWx1 grey, or HWx3 BGR, uint8, as ``cv2.imencode``
    takes it) as a baseline JPEG: libjpeg-turbo's default compression at
    ``quality`` (0-100) with ``subsampling`` ``"420"`` or ``"444"`` chroma.
    The defaults give the bytes of ``cv2.imencode('.jpg', img)``. HWx4 is
    CMYK samples, written 4:4:4 with an Adobe marker as libjpeg writes
    PIL's CMYK JPEG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg needs uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        raise ValueError(f"encode_jpeg needs HW grey, HWx3 BGR or HWx4 CMYK, got {img.shape}")
    if subsampling not in SUBSAMPLINGS:
        raise ValueError(f"subsampling={subsampling!r}: one of {sorted(SUBSAMPLINGS)}")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    lib = load_encoder()
    out = np.empty(lib.yolov6_jpeg_encode_bound(w, h), np.uint8)
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.yolov6_jpeg_encode(img.ctypes.data, w, h, 1 if img.ndim == 2 else img.shape[2],
                              int(quality),
                              SUBSAMPLINGS[subsampling], out.ctypes.data, out.size,
                              ctypes.byref(n), err, _ERRLEN):
        raise ValueError(f"encode_jpeg: {err.value.decode(errors='replace')}")
    return out[:n.value].tobytes()
