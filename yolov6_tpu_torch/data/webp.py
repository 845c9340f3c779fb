"""WebP reading and writing without libwebp, cv2 or PIL: what ``cv2.imread``
returns for a ``.webp`` file (libwebp's ``WebPDecodeBGRInto`` behind OpenCV
5) and a lossless writer in place of ``cv2.imwrite('x.webp')``.

The RIFF container: a simple ``VP8 `` (lossy) or ``VP8L`` (lossless) file,
or ``VP8X`` with ``ALPH``, ``ICCP``, ``EXIF``, ``XMP ``, ``ANIM`` and
``ANMF`` chunks. The bitstreams decode in ``csrc/webp_decode.cc``. As cv2
reads them:

- alpha is dropped without premultiplying: the ``ALPH`` chunk is parsed
  for its header and not decoded (its filter and compression act on alpha
  only, so the colour is VP8's whatever they are), a VP8L image's alpha
  channel is dropped;
- an animated file gives its first frame on the canvas: the frame at its
  offset, the rest of the canvas black (libwebp's anim decoder starts from
  a zeroed canvas and decodes the first frame into it unblended);
- the Exif orientation of an ``EXIF`` chunk is applied as OpenCV applies
  it (``data/jpeg.py::orient``).

``webp_size`` gives the canvas ``(w, h)``, swapped under Exif orientation 6
or 8 as PIL's ``WebPImageFile._getexif`` makes the JAX package's
``check_image`` record it.

``encode_webp`` writes a lossless VP8L file (cv2's default for ``.webp``)
that decodes to the image exactly. Its bytes are not libwebp's: it has the
subtract-green and a left-neighbour predictor transform, one Huffman group
and no LZ77, where libwebp's encoder searches for a smaller file.
"""

from __future__ import annotations

import ctypes
import heapq
import os
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

from yolov6_tpu_torch.data.exif import exif_orientation
from yolov6_tpu_torch.data.jpeg import orient
from yolov6_tpu_torch.data.native_aug import build_library, library_path

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "webp_decode.cc")
_ERRLEN = 256

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def is_webp(head: bytes) -> bool:
    """Whether the leading bytes are a RIFF WebP header."""
    return len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"WEBP"


def load() -> ctypes.CDLL:
    """The library built from ``csrc/webp_decode.cc``, compiled if needed."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path(SOURCE)
            if not os.path.exists(so):
                build_library(SOURCE, so)
            lib = ctypes.CDLL(so)
            int_p = ctypes.POINTER(ctypes.c_int)
            for name in ("yolov6_webp_vp8l_size", "yolov6_webp_vp8_size"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, int_p, int_p, ctypes.c_char_p,
                               ctypes.c_int]
            for name in ("yolov6_webp_vp8l_decode", "yolov6_webp_vp8_decode"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


def chunks(data: bytes, path: str = "<bytes>") -> List[Tuple[bytes, bytes]]:
    """The RIFF chunks of a WebP file: ``(fourcc, payload)`` in order."""
    if not is_webp(data[:12]):
        raise ValueError(f"{path}: not a RIFF WebP file")
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    out, pos = [], 12
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        n = struct.unpack_from("<I", data, pos + 4)[0]
        payload = data[pos + 8:pos + 8 + n]
        if len(payload) < n:
            raise ValueError(f"{path}: truncated WebP chunk {kind.decode(errors='replace')!r}")
        out.append((kind, payload))
        pos += 8 + n + (n & 1)
    if not out:
        raise ValueError(f"{path}: WebP file without chunks")
    return out


def _bitstream_size(kind: bytes, payload: bytes, path: str) -> Tuple[int, int]:
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    fn = load().yolov6_webp_vp8l_size if kind == b"VP8L" else load().yolov6_webp_vp8_size
    if fn(payload, len(payload), ctypes.byref(w), ctypes.byref(h), err, _ERRLEN):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return w.value, h.value


def _frame(parts: List[Tuple[bytes, bytes]], path: str) -> Tuple[bytes, bytes]:
    """The ``VP8 ``/``VP8L`` chunk of an image or of an ``ANMF`` frame; an
    ``ALPH`` chunk before it is checked and left undecoded."""
    for kind, payload in parts:
        if kind == b"ALPH":
            if not payload:
                raise ValueError(f"{path}: empty WebP ALPH chunk")
            if payload[0] & 3 > 1 or (payload[0] >> 2) & 3 > 3:
                raise ValueError(f"{path}: WebP ALPH chunk of compression {payload[0] & 3}")
        if kind in (b"VP8 ", b"VP8L"):
            return kind, payload
    raise ValueError(f"{path}: WebP without a VP8 or VP8L bitstream")


def _info(data: bytes, path: str):
    """``(canvas w, h, orientation, bitstream kind, payload, frame x, y)``."""
    parts = chunks(data, path)
    orientation = 1
    for kind, payload in parts:
        if kind == b"EXIF":
            orientation = exif_orientation(payload)
            break
    first = parts[0][0]
    if first in (b"VP8 ", b"VP8L"):
        kind, payload = parts[0]
        w, h = _bitstream_size(kind, payload, path)
        return w, h, orientation, kind, payload, 0, 0
    if first != b"VP8X":
        raise ValueError(f"{path}: WebP file whose first chunk is {first!r}")
    vp8x = parts[0][1]
    if len(vp8x) < 10:
        raise ValueError(f"{path}: truncated WebP VP8X chunk")
    cw = 1 + int.from_bytes(vp8x[4:7], "little")
    ch = 1 + int.from_bytes(vp8x[7:10], "little")
    frames = [p for k, p in parts if k == b"ANMF"]
    if frames:
        f = frames[0]
        if len(f) < 16:
            raise ValueError(f"{path}: truncated WebP ANMF chunk")
        fx = 2 * int.from_bytes(f[0:3], "little")
        fy = 2 * int.from_bytes(f[3:6], "little")
        sub, pos = [], 16
        while pos + 8 <= len(f):
            n = struct.unpack_from("<I", f, pos + 4)[0]
            sub.append((f[pos:pos + 4], f[pos + 8:pos + 8 + n]))
            pos += 8 + n + (n & 1)
        kind, payload = _frame(sub, path)
        return cw, ch, orientation, kind, payload, fx, fy
    kind, payload = _frame(parts[1:], path)
    return cw, ch, orientation, kind, payload, 0, 0


def webp_size(data: bytes, path: str = "<bytes>") -> Tuple[int, int]:
    """The canvas ``(w, h)`` as the JAX package's ``check_image`` records it
    through PIL: swapped under Exif orientation 6 or 8."""
    w, h, orientation = _info(data, path)[:3]
    return (h, w) if orientation in (6, 8) else (w, h)


def decode_bitstream(kind: bytes, payload: bytes, path: str = "<bytes>") -> np.ndarray:
    """A ``VP8 `` or ``VP8L`` bitstream as HxWx3 uint8 BGR (alpha dropped)."""
    w, h = _bitstream_size(kind, payload, path)
    err = ctypes.create_string_buffer(_ERRLEN)
    lib = load()
    if kind == b"VP8L":
        argb = np.empty((h, w), np.uint32)
        if lib.yolov6_webp_vp8l_decode(payload, len(payload), w, h, argb.ctypes.data, err,
                                       _ERRLEN):
            raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
        return np.ascontiguousarray(argb.view(np.uint8).reshape(h, w, 4)[:, :, :3])
    out = np.empty((h, w, 3), np.uint8)
    if lib.yolov6_webp_vp8_decode(payload, len(payload), w, h, out.ctypes.data, err, _ERRLEN):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return out


def decode_webp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The WebP ``data`` as ``cv2.imread`` returns it: HxWx3 uint8 BGR, the
    first frame of an animation on its canvas, the Exif orientation
    applied. Raises ``ValueError`` naming ``path`` for a file it does not
    decode."""
    cw, ch, orientation, kind, payload, fx, fy = _info(data, path)
    img = decode_bitstream(kind, payload, path)
    h, w = img.shape[:2]
    if (w, h) != (cw, ch) or fx or fy:
        if fx + w > cw or fy + h > ch:
            raise ValueError(f"{path}: WebP frame of {w}x{h} at ({fx}, {fy}) outside its "
                             f"{cw}x{ch} canvas")
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[fy:fy + h, fx:fx + w] = img
        img = canvas
    return orient(img, orientation)


# ---------------------------------------------------------------- the writer

def _huffman_lengths(freq: np.ndarray, limit: int = 15) -> np.ndarray:
    """Code lengths of at most ``limit`` bits for the symbols of ``freq``
    (zero where the frequency is zero), a complete code when two or more
    symbols occur."""
    freq = freq.astype(np.int64)
    while True:
        used = np.flatnonzero(freq)
        lengths = np.zeros(len(freq), np.int64)
        if len(used) < 2:
            lengths[used] = 1
            return lengths
        heap = [(int(freq[s]), i, [int(s)]) for i, s in enumerate(used)]
        heapq.heapify(heap)
        tie = len(heap)
        while len(heap) > 1:
            fa, _, a = heapq.heappop(heap)
            fb, _, b = heapq.heappop(heap)
            lengths[a + b] += 1
            heapq.heappush(heap, (fa + fb, tie, a + b))
            tie += 1
        if lengths.max() <= limit:
            return lengths
        freq = np.where(freq > 0, (freq >> 1) | 1, 0)


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes of ``lengths``, bit-reversed for the LSB-first
    stream (a Huffman code goes out most significant bit first)."""
    codes = np.zeros(len(lengths), np.int64)
    code = 0
    for ln in range(1, 16):
        for s in np.flatnonzero(lengths == ln):
            codes[s] = int(f"{code:0{ln}b}"[::-1], 2)
            code += 1
        code <<= 1
    return codes


class _Bits:
    """LSB-first bit writer over numpy arrays of (value, width) pairs."""

    def __init__(self):
        self.values: List[np.ndarray] = []
        self.widths: List[np.ndarray] = []

    def put(self, value, width):
        self.values.append(np.atleast_1d(np.asarray(value, np.int64)))
        self.widths.append(np.atleast_1d(np.asarray(width, np.int64)))

    def tobytes(self) -> bytes:
        v = np.concatenate(self.values)
        w = np.concatenate(self.widths)
        keep = w > 0
        v, w = v[keep], w[keep]
        total = int(w.sum())
        starts = np.repeat(np.cumsum(w) - w, w)
        offsets = np.arange(total) - starts
        bits = ((np.repeat(v, w) >> offsets) & 1).astype(np.uint8)
        return np.packbits(bits, bitorder="little").tobytes()


def _write_code(bits: _Bits, lengths: np.ndarray) -> None:
    """One Huffman code: the simple form for one or two symbols below 256,
    else the code lengths through a code-length code of sixteen 4-bit
    codes (0-15)."""
    used = np.flatnonzero(lengths)
    if len(used) <= 2 and (len(used) == 0 or used.max() < 256):
        syms = list(used) or [0]
        bits.put(1, 1)
        bits.put(len(syms) - 1, 1)
        bits.put(1, 1)  # 8-bit first symbol
        for s in syms:
            bits.put(int(s), 8)
        return
    bits.put(0, 1)
    bits.put(19 - 4, 4)
    order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    for sym in order:
        bits.put(4 if sym < 16 else 0, 3)
    bits.put(0, 1)  # no max_symbol: every length follows
    rev = np.array([int(f"{c:04b}"[::-1], 2) for c in range(16)], np.int64)
    bits.put(rev[lengths], np.full(len(lengths), 4))


def encode_webp(img: np.ndarray) -> bytes:
    """``img`` (HW grey, HWx3 BGR or HWx4 BGRA, uint8) as a lossless VP8L
    WebP that ``cv2.imread`` reads back to the image exactly (alpha
    dropped)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_webp needs uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if not (img.ndim == 3 and img.shape[2] in (3, 4)):
        raise ValueError(f"encode_webp needs HW, HWx3 or HWx4, got {img.shape}")
    h, w = img.shape[:2]
    if not (0 < w <= 16384 and 0 < h <= 16384):
        raise ValueError(f"encode_webp: {w}x{h} is outside WebP's 16384x16384")
    has_alpha = img.shape[2] == 4
    alpha = img[:, :, 3] if has_alpha else np.full((h, w), 255, np.uint8)
    # subtract-green, then the predictor transform with every pixel predicted
    # from its left neighbour (mode 1; the first row from the left, the first
    # column from above, the first pixel from opaque black, as VP8L fixes them)
    argb = np.stack([alpha, img[:, :, 2] - img[:, :, 1], img[:, :, 1],
                     img[:, :, 0] - img[:, :, 1]], axis=2)
    pred = np.zeros_like(argb)
    pred[:, 1:] = argb[:, :-1]
    pred[1:, 0] = argb[:-1, 0]
    pred[0, 0] = (255, 0, 0, 0)
    res = (argb - pred).reshape(-1, 4).astype(np.int64)
    a, r, g, b = res[:, 0], res[:, 1], res[:, 2], res[:, 3]
    bits = _Bits()
    bits.put(0x2F, 8)
    bits.put(w - 1, 14)
    bits.put(h - 1, 14)
    bits.put(int(has_alpha), 1)
    bits.put(0, 3)  # version
    bits.put([1, 2], [1, 2])  # a transform: subtract-green (2)
    bits.put([1, 0, 9 - 2], [1, 2, 3])  # a transform: predictor (0), 512-pixel tiles
    # its sub-image: one colour (mode 1 in green) through one-symbol codes
    bits.put(0, 1)  # no colour cache
    for sym in (1, 0, 0, 255, 0):  # green, red, blue, alpha, distance
        _write_code(bits, np.bincount([sym], minlength=280 if sym == 1 else 256))
    bits.put(0, 1)  # no more transforms
    bits.put(0, 1)  # no colour cache
    bits.put(0, 1)  # no meta Huffman image
    tables = []
    for chan, size in ((g, 280), (r, 256), (b, 256), (a, 256)):
        lengths = _huffman_lengths(np.bincount(chan, minlength=size))
        _write_code(bits, lengths)
        tables.append((_canonical_codes(lengths), lengths))
    _write_code(bits, np.zeros(40, np.int64))  # distances: unused
    # the pixels: green, red, blue, alpha codes interleaved pixel by pixel
    # (a code of one symbol takes no bits)
    vals = np.stack([codes[chan] for (codes, _), chan in zip(tables, (g, r, b, a))], axis=1)
    wids = np.stack([np.where(np.count_nonzero(lens) > 1, lens[chan], 0)
                     for (_, lens), chan in zip(tables, (g, r, b, a))], axis=1)
    bits.put(vals.reshape(-1), wids.reshape(-1))
    payload = bits.tobytes()
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
