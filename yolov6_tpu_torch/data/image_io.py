"""Image reading and writing without cv2 or PIL: the port's stand-in for
``cv2.imread``, ``cv2.imwrite`` and the header read of ``check_image``
(yolov6_tpu/data/datasets.py:41-91).

The machine with the card has neither cv2 nor PIL, so the loaders read their
images here. ``imread`` dispatches on the leading bytes and returns what
``cv2.imread(path)`` returns, pixel for pixel:

- PNG, decoded with zlib and numpy: every colour type (grey, RGB, palette,
  grey+alpha, RGBA) at every depth PNG allows (1-16 bits), interlaced
  (Adam7) or not. As OpenCV asks libpng: 16-bit samples keep their high
  byte, 1/2/4-bit grey scales to 8 bits, a palette expands to its colours,
  and alpha and ``tRNS`` are dropped. The CRC of each critical chunk is
  checked.
- JPEG, decoded by ``data/jpeg.py`` (C++), bit-equal to ``cv2.imread``:
  sequential and progressive Huffman, 8-bit, grey or colour, the Exif
  orientation applied, a file that ends early grey past its end.
- BMP, as OpenCV's own reader (grfmt_bmp.cpp) decodes it: uncompressed 1, 4
  and 8-bit palette, 16-bit (5-5-5, and 5-6-5 under ``BI_BITFIELDS``, each
  sample shifted up without rounding), 24 and 32-bit (the fourth byte
  dropped), bottom-up or top-down.

Any other format (TIFF, WebP, GIF, ...) and the kinds not decoded (RLE BMP,
the JPEG kinds ``data/jpeg.py`` names) raise ``ValueError`` naming the file
and the format. ``imwrite`` writes JPEG (``data/jpeg.py::encode_jpeg``, the
bytes ``cv2.imwrite`` writes) or PNG by the suffix, as ``cv2.imwrite``
chooses.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from yolov6_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg, jpeg_size

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"  # SOI and a marker's FF, as OpenCV's JPEG decoder checks
BMP_SIGNATURE = b"BM"
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")
_FORMATS = (  # leading bytes -> name, for the error of a file the port does not read
    (b"GIF8", "GIF"),
    (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"),
    (b"RIFF", "RIFF/WebP"),
)


def _unknown(path: str, head: bytes) -> ValueError:
    name = next((n for magic, n in _FORMATS if head.startswith(magic)), "an unknown format")
    return ValueError(f"{path}: {name} file; the port reads PNG, JPEG and BMP only")


def _read_ihdr(path: str, data: bytes):
    """(width, height, bit depth, colour type, interlace) from the PNG header."""
    if not data.startswith(PNG_SIGNATURE):
        raise _unknown(path, data[:8])
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: PNG without an IHDR chunk first")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    if w == 0 or h == 0:
        raise ValueError(f"{path}: PNG of size {w}x{h}")
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"{path}: PNG of colour type {ctype} at {depth} bits is not valid")
    if interlace > 1:
        raise ValueError(f"{path}: PNG interlace method {interlace} is not valid")
    return w, h, depth, ctype, interlace


def _bmp_header(path: str, data: bytes):
    """(width, height, bits a pixel, compression, header size, top_down)
    from a BMP's file and DIB headers."""
    if len(data) < 26:
        raise ValueError(f"{path}: truncated BMP header")
    hsize = struct.unpack_from("<I", data, 14)[0]
    if hsize == 12:  # OS/2 BITMAPCOREHEADER
        w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
        comp = 0
    elif hsize in (40, 52, 56, 64, 108, 124) and len(data) >= 14 + 40:
        w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
    else:
        raise ValueError(f"{path}: BMP with a {hsize}-byte DIB header is not supported")
    if comp in (1, 2):
        raise ValueError(f"{path}: {'RLE8' if comp == 1 else 'RLE4'} BMP; the port reads "
                         "uncompressed BMP only")
    if comp not in (0, 3):
        raise ValueError(f"{path}: BMP compression {comp} (JPEG/PNG inside a BMP) is not "
                         "supported")
    if w <= 0 or h == 0:
        raise ValueError(f"{path}: BMP of size {w}x{h}")
    return w, abs(h), bpp, comp, hsize, h < 0


def image_format(path: str):
    """``"jpeg"``, ``"png"`` or ``"bmp"`` from the leading bytes of the file
    at ``path`` (PIL's ``Image.format``, lower case), else None."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(JPEG_SIGNATURE):
        return "jpeg"
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(BMP_SIGNATURE):
        return "bmp"
    return None


def image_size(path: str):
    """``(w, h)`` of a PNG, JPEG or BMP from its headers, without decoding
    the pixels. For a JPEG with Exif orientation 6 or 8, w and h are
    swapped, as ``check_image`` records them; under orientations 5 and 7
    ``imread`` transposes the image while the recorded shape stays as
    stored (the JAX package's quirk, kept so that both packages record the
    same shapes)."""
    with open(path, "rb") as f:
        head = f.read(54)
        if head.startswith(JPEG_SIGNATURE):
            w, h, orientation = jpeg_size(head + f.read(), path)
            return (h, w) if orientation in (6, 8) else (w, h)
    if head.startswith(BMP_SIGNATURE):
        w, h = _bmp_header(path, head)[:2]
        return w, h
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


def _unpack_samples(rows: np.ndarray, width: int, depth: int, spp: int) -> np.ndarray:
    """Unfiltered PNG rows -> (rows, width, spp) samples, uint16 at 16 bits,
    else uint8 (sub-byte samples as their values, not yet scaled)."""
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)[:, :width * spp].reshape(len(rows), width, spp)
    if depth == 8:
        return rows[:, :width * spp].reshape(len(rows), width, spp)
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # MSB first
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(len(rows), -1)[:, :width * spp].reshape(len(rows), width, spp)


def _decode_png(path: str, data: bytes) -> np.ndarray:
    w, h, depth, ctype, interlace = _read_ihdr(path, data)
    idat, palette, pos = [], None, 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if kind in _CRITICAL:
            if len(payload) < length or pos + 12 + length > len(data):
                raise ValueError(f"{path}: truncated PNG chunk {kind.decode(errors='replace')}")
            crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
            if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
                raise ValueError(f"{path}: corrupt PNG: CRC error in {kind.decode()}")
        if kind == b"IDAT":
            idat.append(payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8)[:len(payload) // 3 * 3].reshape(-1, 3)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    spp = _SAMPLES[ctype]
    bits = spp * depth
    bpp = max(1, bits // 8)  # the filters' byte distance
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data: {e}") from None
    px = np.zeros((h, w, spp), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no bytes, not even filter bytes
        stride = (pw * bits + 7) // 8
        n = ph * (stride + 1)
        if raw.size < off + n:
            raise ValueError(f"{path}: truncated PNG data ({raw.size} of at least {off + n} "
                             "bytes)")
        rows = _unfilter(raw[off:off + n], ph, stride, bpp, path)
        off += n
        px[y0::dy, x0::dx] = _unpack_samples(np.ascontiguousarray(rows), pw, depth, spp)
    if depth == 16:  # libpng's png_set_strip_16: the high byte
        px = (px >> 8).astype(np.uint8)
    if ctype == 3:
        idx = px[:, :, 0]
        if idx.max() >= len(palette):  # libpng takes an index past the palette as black
            palette = np.concatenate([palette, np.zeros((256 - len(palette), 3), np.uint8)])
        return np.ascontiguousarray(palette[idx][:, :, ::-1])
    if depth < 8:  # png_set_expand_gray_1_2_4_to_8: v * 255 / (2^depth - 1)
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):  # grey, alpha dropped
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, 2::-1])  # RGB(A) -> BGR


def _decode_bmp(path: str, data: bytes) -> np.ndarray:
    w, h, bpp, comp, hsize, top_down = _bmp_header(path, data)
    offset = struct.unpack_from("<I", data, 10)[0]
    stride = (w * bpp + 31) // 32 * 4
    if len(data) < offset + stride * h:
        raise ValueError(f"{path}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp in (1, 4, 8):
        entry = 3 if hsize == 12 else 4
        n_used = 0 if hsize == 12 else struct.unpack_from("<I", data, 46)[0]
        n = n_used or (1 << bpp)
        start = 14 + hsize
        pal = np.frombuffer(data[start:start + n * entry], np.uint8)
        pal = pal[:len(pal) // entry * entry].reshape(-1, entry)[:, :3]
        pal = np.concatenate([pal, np.zeros((256 - len(pal), 3), np.uint8)])
        idx = _unpack_samples(np.ascontiguousarray(rows), w, bpp, 1)[:, :, 0]
        return np.ascontiguousarray(pal[idx])
    if bpp == 16:
        masks = (0x7C00, 0x03E0, 0x001F)
        if comp == 3:
            at = 54 if hsize == 40 else 14 + 40
            masks = struct.unpack_from("<III", data, at)
        v = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
        if masks == (0xF800, 0x07E0, 0x001F):  # 5-6-5
            bgr = [(v << 3) & 255, (v >> 3) & ~3 & 255, (v >> 8) & ~7 & 255]
        elif masks == (0x7C00, 0x03E0, 0x001F):  # 5-5-5
            bgr = [(v << 3) & 255, (v >> 2) & ~7 & 255, (v >> 7) & ~7 & 255]
        else:
            raise ValueError(f"{path}: 16-bit BMP with masks {[hex(m) for m in masks]}; the "
                             "port reads 5-5-5 and 5-6-5")
        return np.stack(bgr, axis=2).astype(np.uint8)
    if bpp in (24, 32):
        c = bpp // 8
        return np.ascontiguousarray(rows[:, :c * w].reshape(h, w, c)[:, :, :3])
    raise ValueError(f"{path}: {bpp}-bit BMP is not supported")


def imread(path: str) -> np.ndarray:
    """The image at ``path`` as ``cv2.imread(path)`` returns it: HWC uint8, 3
    channels, BGR. Grey is replicated and alpha dropped; a JPEG's Exif
    orientation is applied. Raises ``ValueError`` on any other format and on
    the kinds not decoded (see the module doc)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data, path)
    if data.startswith(BMP_SIGNATURE):
        return _decode_bmp(path, data)
    return _decode_png(path, data)


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


def encode_bmp(img: np.ndarray) -> bytes:
    """``img`` (HWx3 BGR uint8) as an uncompressed 24-bit bottom-up BMP."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_bmp needs HWx3 uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1].reshape(h, -1)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 0, 0, 0, 0)
    return (BMP_SIGNATURE + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + info
            + rows.tobytes())


def imwrite(path: str, img: np.ndarray) -> None:
    """Write ``img`` (HWC BGR uint8; HW grey for JPEG and PNG) to ``path`` in
    the format its suffix names, as ``cv2.imwrite`` chooses:
    ``.jpg``/``.jpeg`` as JPEG at cv2's defaults (quality 95, 4:2:0; the
    bytes cv2 writes), ``.png`` as PNG (``encode_png``), ``.bmp`` as 24-bit
    BMP. Any other suffix raises ``ValueError``."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        data = encode_jpeg(img)
    elif ext == ".png":
        data = encode_png(img)
    elif ext == ".bmp":
        data = encode_bmp(img)
    else:
        raise ValueError(f"{path}: the port writes .jpg, .jpeg, .png and .bmp only")
    with open(path, "wb") as f:
        f.write(data)
