"""Image reading and writing without cv2 or PIL: the port's stand-in for
``cv2.imread``, ``cv2.imwrite`` and the header read of ``check_image``
(yolov6_tpu/data/datasets.py:41-91).

The machine with the card has neither cv2 nor PIL, so the loaders read their
images here. ``imread`` dispatches on the leading bytes:

- PNG, decoded with zlib and numpy: 8-bit, non-interlaced, colour type 0
  (grey), 2 (RGB) and 6 (RGBA). PNG is lossless, so ``imread`` returns
  exactly the pixels ``cv2.imread`` returns.
- JPEG, decoded by ``data/jpeg.py`` (C++), bit-equal to ``cv2.imread``:
  baseline and extended sequential Huffman, 8-bit, grey or colour, the Exif
  orientation applied.

Any other format, and the kinds of PNG and JPEG not decoded, raise
``ValueError`` naming the file and the format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from yolov6_tpu_torch.data.jpeg import decode_jpeg, jpeg_size

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"  # SOI and a marker's FF, as OpenCV's JPEG decoder checks
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel
_FORMATS = (  # leading bytes -> name, for the error of a file neither PNG nor JPEG
    (b"BM", "BMP"),
    (b"GIF8", "GIF"),
    (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"),
    (b"RIFF", "RIFF/WebP"),
)


def _not_png(path: str, head: bytes) -> ValueError:
    name = next((n for magic, n in _FORMATS if head.startswith(magic)), "an unknown format")
    return ValueError(f"{path}: {name} file; the port reads PNG and JPEG only")


def _read_ihdr(path: str, data: bytes):
    """(width, height, bit depth, colour type, interlace) from the PNG header."""
    if not data.startswith(PNG_SIGNATURE):
        raise _not_png(path, data[:8])
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: PNG without an IHDR chunk first")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    if w == 0 or h == 0:
        raise ValueError(f"{path}: PNG of size {w}x{h}")
    return w, h, depth, ctype, interlace


def image_size(path: str):
    """``(w, h)`` of a PNG or JPEG from its headers, without decoding the
    pixels. For a JPEG with Exif orientation 6 or 8, w and h are swapped, as
    ``check_image`` records them; under orientations 5 and 7 ``imread``
    transposes the image while the recorded shape stays as stored (the JAX
    package's quirk, kept so that both packages record the same shapes)."""
    with open(path, "rb") as f:
        head = f.read(33)
        if head.startswith(JPEG_SIGNATURE):
            w, h, orientation = jpeg_size(head + f.read(), path)
            return (h, w) if orientation in (6, 8) else (w, h)
    w, h, _, _, _ = _read_ihdr(path, head)
    return w, h


def _paeth_or_average_row(line: np.ndarray, prev: np.ndarray, bpp: int, paeth: bool) -> np.ndarray:
    """Undo the Average (3) or Paeth (4) filter of one row: each byte depends
    on the one ``bpp`` to its left, so this is a loop over the row."""
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if paeth:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    ftypes, data = rows[:, 0], rows[:, 1:]
    if not ftypes.any():  # every row unfiltered: what imwrite_png writes
        return data
    if ftypes.max() > 4:
        raise ValueError(f"{path}: PNG row filter {int(ftypes.max())} is not one of 0-4")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = int(ftypes[y]), data[y]
        if f == 0:
            out[y] = line
        elif f == 1:  # Sub: a running sum of each byte lane, mod 256
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:  # Up
            out[y] = line + prev
        else:
            out[y] = _paeth_or_average_row(line, prev, bpp, paeth=f == 4)
        prev = out[y]
    return out


def imread(path: str) -> np.ndarray:
    """The image at ``path`` as ``cv2.imread(path)`` returns it: HWC uint8, 3
    channels, BGR. Grey is replicated and alpha dropped; a JPEG's Exif
    orientation is applied. Raises ``ValueError`` on any other format and on
    the kinds not decoded (a 16-bit or interlaced PNG, a progressive JPEG)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data, path)
    w, h, depth, ctype, interlace = _read_ihdr(path, data)
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; the port reads 8-bit PNG only")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype}; the port reads types 0, 2 and 6")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG; the port reads non-interlaced PNG only")
    idat, pos = [], 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        elif kind == b"IEND":
            break
        pos += 12 + length
    cn = _CHANNELS[ctype]
    stride = w * cn
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data: {e}") from None
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG data ({raw.size} of {h * (stride + 1)} bytes)")
    px = _unfilter(raw[:h * (stride + 1)], h, stride, cn, path).reshape(h, w, cn)
    if cn == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[:, :, 2::-1])  # RGB(A) -> BGR


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """``img`` as ``cv2.imwrite`` takes it (HW grey, HWC BGR or BGRA, uint8)
    encoded as an 8-bit PNG, every row with filter type 0, deflated by zlib at
    level 1 (fast; noisy pixels barely compress at any level)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"imwrite_png needs uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        ctype, px = 0, img
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype = 2 if img.shape[2] == 3 else 6
        px = np.concatenate([img[:, :, 2::-1], img[:, :, 3:]], axis=2)  # BGR(A) -> RGB(A)
    else:
        raise ValueError(f"imwrite_png needs HW, HWx3 or HWx4, got {img.shape}")
    h, w = px.shape[:2]
    rows = np.zeros((h, 1 + px[0].size), np.uint8)  # a 0 filter byte leads each row
    rows[:, 1:] = px.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def imwrite_png(path: str, img: np.ndarray) -> None:
    """Write ``img`` (as ``encode_png`` takes it) to ``path`` as a PNG."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
