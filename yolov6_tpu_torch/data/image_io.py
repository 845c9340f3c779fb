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
  checked. The Exif orientation of an ``eXIf`` chunk, before or after the
  image data, is applied.
- JPEG, decoded by ``data/jpeg.py`` (C++), bit-equal to ``cv2.imread``:
  sequential and progressive Huffman, 8-bit, grey, colour or CMYK/YCCK, the
  Exif orientation applied, a file that ends early grey past its end. An
  MPO (a JPEG whose MPF segment lists more than one image) gives its first
  image.
- BMP, as OpenCV's own reader (grfmt_bmp.cpp) decodes it: uncompressed 1, 4
  and 8-bit palette, 16-bit (5-5-5, and 5-6-5 under ``BI_BITFIELDS``, each
  sample shifted up without rounding), 24 and 32-bit (the fourth byte
  dropped), bottom-up or top-down; RLE8 and RLE4 with encoded and absolute
  runs and the end-of-line, end-of-bitmap and delta escapes, the pixels an
  escape skips filled with palette entry 0.
- TIFF (and DNG, a TIFF) through ``data/tiff.py`` and WebP through
  ``data/webp.py``, as those modules set out.

GIF and any other format, and the kinds not decoded (arithmetic-coded and
12-bit JPEG, the TIFF kinds ``data/tiff.py`` names, an RLE run past its
row) raise ``ValueError`` naming the file and the kind. ``imwrite`` writes
JPEG (``data/jpeg.py::encode_jpeg``, the bytes ``cv2.imwrite`` writes), PNG,
BMP, TIFF (``data/tiff.py::encode_tiff``, cv2's bytes) or lossless WebP
(``data/webp.py::encode_webp``) by the suffix, as ``cv2.imwrite`` chooses.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

from yolov6_tpu_torch.data.exif import exif_orientation
from yolov6_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg, jpeg_size, orient
from yolov6_tpu_torch.data.tiff import SIGNATURES as TIFF_SIGNATURES
from yolov6_tpu_torch.data.tiff import decode_tiff, encode_tiff, tiff_size
from yolov6_tpu_torch.data.webp import decode_webp, encode_webp, is_webp, webp_size

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
    (b"RIFF", "RIFF (not WebP)"),
)
READS = "PNG, JPEG (MPO), BMP, TIFF (DNG) and WebP"


def _unknown(path: str, head: bytes) -> ValueError:
    name = next((n for magic, n in _FORMATS if head.startswith(magic)), "an unknown format")
    return ValueError(f"{path}: {name} file; the port reads {READS}")


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
    if comp in (1, 2) and (bpp != 8 if comp == 1 else bpp != 4):
        raise ValueError(f"{path}: {'RLE8' if comp == 1 else 'RLE4'} BMP at {bpp} bits")
    if comp not in (0, 1, 2, 3):
        raise ValueError(f"{path}: BMP compression {comp} (JPEG/PNG inside a BMP) is not "
                         "supported")
    if w <= 0 or h == 0:
        raise ValueError(f"{path}: BMP of size {w}x{h}")
    return w, abs(h), bpp, comp, hsize, h < 0


def mpo_images(data: bytes) -> int:
    """The number of images an APP2 ``MPF`` segment of the JPEG ``data``
    lists (its MP header's NumberOfImages, tag 45057), 1 without one: PIL
    names a JPEG with more than one an MPO."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xD9, 0xDA):
            break
        n = struct.unpack_from(">H", data, pos + 2)[0]
        seg = data[pos + 4:pos + 2 + n]
        if marker == 0xE2 and seg.startswith(b"MPF\x00") and len(seg) >= 12:
            t = seg[4:]
            e = "<" if t[:2] == b"II" else ">"
            try:
                off = struct.unpack_from(e + "I", t, 4)[0]
                for k in range(struct.unpack_from(e + "H", t, off)[0]):
                    tag, _, _, value = struct.unpack_from(e + "HHII", t, off + 2 + 12 * k)
                    if tag == 45057:
                        return value
            except struct.error:
                return 1
            return 1
        pos += 2 + n
    return 1


def image_format(path: str):
    """PIL's ``Image.format`` of the file at ``path``, lower case, from its
    leading bytes: ``"jpeg"``, ``"mpo"``, ``"png"``, ``"bmp"``, ``"tiff"``
    (a DNG too) or ``"webp"``, else None."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head.startswith(JPEG_SIGNATURE):
            return "mpo" if mpo_images(head + f.read()) > 1 else "jpeg"
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(BMP_SIGNATURE):
        return "bmp"
    if head[:4] in TIFF_SIGNATURES:
        return "tiff"
    if is_webp(head):
        return "webp"
    return None


def _png_exif(f) -> int:
    """The orientation of the first ``eXIf`` chunk of the PNG open as ``f``
    (before or after the image data), 1 without one: the chunks' headers
    are read and their payloads skipped."""
    pos = 8
    while True:
        f.seek(pos)
        head = f.read(8)
        if len(head) < 8:
            return 1
        length, kind = struct.unpack(">I4s", head)
        if kind == b"eXIf":
            return exif_orientation(f.read(length))
        if kind == b"IEND":
            return 1
        pos += 12 + length


def image_size(path: str):
    """``(w, h)`` of an image from its headers, as the JAX package's
    ``check_image`` records it through PIL, without decoding the pixels.
    For a JPEG, PNG or WebP with Exif orientation 6 or 8, w and h are
    swapped (PIL's ``_getexif``); under orientations 5 and 7 ``imread``
    transposes the image while the recorded shape stays as stored (the JAX
    package's quirk, kept so that both packages record the same shapes). A
    TIFF has no ``_getexif``: its shape is IFD0's as stored."""
    with open(path, "rb") as f:
        head = f.read(54)
        if head.startswith(BMP_SIGNATURE):
            return _bmp_header(path, head)[:2]
        if head.startswith(PNG_SIGNATURE):
            w, h, _, _, _ = _read_ihdr(path, head)
            return (h, w) if _png_exif(f) in (6, 8) else (w, h)
        data = head + f.read()
    if data.startswith(JPEG_SIGNATURE):
        w, h, orientation = jpeg_size(data, path)
        return (h, w) if orientation in (6, 8) else (w, h)
    if data[:4] in TIFF_SIGNATURES:
        return tiff_size(data, path)
    if is_webp(data[:12]):
        return webp_size(data, path)
    raise _unknown(path, data[:8])


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
    return orient(_decode_png_stored(path, data), _png_exif(io.BytesIO(data)))


def _decode_png_stored(path: str, data: bytes) -> np.ndarray:
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


def _bmp_palette(data: bytes, hsize: int, bpp: int) -> np.ndarray:
    """The BMP's colour table, BGR, padded with black to 256 entries."""
    entry = 3 if hsize == 12 else 4
    n_used = 0 if hsize == 12 else struct.unpack_from("<I", data, 46)[0]
    n = n_used or (1 << bpp)
    start = 14 + hsize
    pal = np.frombuffer(data[start:start + n * entry], np.uint8)
    pal = pal[:len(pal) // entry * entry].reshape(-1, entry)[:, :3]
    return np.concatenate([pal, np.zeros((256 - len(pal), 3), np.uint8)])


def _decode_bmp_rle(path: str, data: bytes, w: int, h: int, bpp: int, top_down: bool,
                    pal: np.ndarray) -> np.ndarray:
    """RLE8 (``bpp`` 8) or RLE4 (4) as OpenCV's grfmt_bmp.cpp decodes it: an
    encoded run repeats an index (RLE4 alternates its two nibbles); an
    absolute run copies indices, padded to a 16-bit word; end-of-line and
    end-of-bitmap fill the rest of the row or image, and a delta the pixels
    it steps over (RLE8: dy rows and dx on; RLE4: dx on, as OpenCV 5
    decodes it), with palette entry 0. An RLE8 run
    wraps at the row's end, where the end-of-line that follows is then
    skipped; an RLE4 run does not wrap. A run or absolute run past its row,
    or data that ends before end-of-bitmap, is refused (cv2 returns None,
    and the JAX package's PIL branch raises on a palette image)."""
    kind = "RLE8" if bpp == 8 else "RLE4"
    src = data[struct.unpack_from("<I", data, 10)[0]:]
    idx = np.zeros(w * h, np.uint8)
    pos = 0  # the next pixel, rows in file order (bottom-up unless top_down)
    y, line_end = 0, w
    line_end_flag = 0
    i = 0

    def word():
        nonlocal i
        if i + 2 > len(src):
            raise ValueError(f"{path}: {kind} BMP data ends before its end-of-bitmap")
        i += 2
        return src[i - 2], src[i - 1]

    def fill(count, value):  # OpenCV's FillUniColor: wraps rows, stops at the last
        nonlocal pos, y, line_end
        while True:
            end = min(pos + count, line_end)
            count -= end - pos
            idx[pos:end] = value
            pos = end
            if pos >= line_end:
                line_end += w
                pos = line_end - w
                y += 1
                if y >= h:
                    break
            if count <= 0:
                break

    while True:
        n, code = word()
        if n:  # encoded run
            if bpp == 8:
                if pos + n > line_end:
                    raise ValueError(f"{path}: {kind} BMP run past the end of its row")
                prev = y
                fill(n, code)
                line_end_flag = y - prev
                if y >= h:
                    break
            else:
                if pos + n > line_end:
                    raise ValueError(f"{path}: {kind} BMP run past the end of its row")
                idx[pos:pos + n] = np.resize([code >> 4, code & 15], n)
                pos += n
        elif code > 2:  # absolute run
            if pos + code > line_end:
                raise ValueError(f"{path}: {kind} BMP absolute run past the end of its row")
            nbytes = ((code + 1) & ~1) if bpp == 8 else ((((code + 1) >> 1) + 1) & ~1)
            if i + nbytes > len(src):
                raise ValueError(f"{path}: {kind} BMP data ends before its end-of-bitmap")
            raw = np.frombuffer(src, np.uint8, nbytes, i)
            i += nbytes
            if bpp == 4:
                raw = np.stack([raw >> 4, raw & 15], axis=1).reshape(-1)
            idx[pos:pos + code] = raw[:code]
            pos += code
            line_end_flag = 0
        else:  # escapes: 0 end of line, 1 end of bitmap, 2 delta
            x_shift = line_end - pos
            y_shift = h - y
            if bpp == 8 and not (code or not line_end_flag or x_shift < w):
                line_end_flag = 0
                continue
            if code == 2:
                dx, dy = word()
                # OpenCV 5 steps an RLE8 delta over dy rows and dx pixels,
                # an RLE4 delta over its dx pixels only
                x_shift, y_shift = dx, (dy if bpp == 8 else 0)
            count = x_shift + (y_shift * w if code else 0)
            if y >= h:
                break
            fill(count, 0)
            line_end_flag = 0
            if y >= h:
                break
    rows = idx.reshape(h, w)
    if not top_down:
        rows = rows[::-1]
    return np.ascontiguousarray(pal[rows])


def _decode_bmp(path: str, data: bytes) -> np.ndarray:
    w, h, bpp, comp, hsize, top_down = _bmp_header(path, data)
    if comp in (1, 2):
        return _decode_bmp_rle(path, data, w, h, bpp, top_down, _bmp_palette(data, hsize, bpp))
    offset = struct.unpack_from("<I", data, 10)[0]
    stride = (w * bpp + 31) // 32 * 4
    if len(data) < offset + stride * h:
        raise ValueError(f"{path}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp in (1, 4, 8):
        pal = _bmp_palette(data, hsize, bpp)
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
    """The image at ``path`` as the JAX package's loaders read it:
    ``cv2.imread(path)``'s HWC uint8, 3 channels, BGR, or where cv2 gives
    None for a TIFF their PIL branch's pixels (``data/tiff.py``). Grey is
    replicated and alpha dropped; the Exif orientation of a JPEG, PNG or
    WebP is applied. Raises ``ValueError`` on any other format and on the
    kinds not decoded (see the module doc)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data, path)
    if data.startswith(BMP_SIGNATURE):
        return _decode_bmp(path, data)
    if data[:4] in TIFF_SIGNATURES:
        return decode_tiff(data, path)
    if is_webp(data[:12]):
        return decode_webp(data, path)
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
    """Write ``img`` (HWC BGR uint8; HW grey for JPEG, PNG, TIFF and WebP)
    to ``path`` in the format its suffix names, as ``cv2.imwrite`` chooses:
    ``.jpg``/``.jpeg`` as JPEG at cv2's defaults (quality 95, 4:2:0; the
    bytes cv2 writes), ``.png`` as PNG (``encode_png``), ``.bmp`` as 24-bit
    BMP, ``.tif``/``.tiff`` as cv2's TIFF (``encode_tiff``: its bytes),
    ``.webp`` as lossless WebP (``encode_webp``: its pixels, not libwebp's
    bytes). Any other suffix raises ``ValueError``, as ``cv2.imwrite``
    fails with "could not find a writer" (``.dng`` and ``.mpo`` among them:
    cv2 reads those and writes neither)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        data = encode_jpeg(img)
    elif ext == ".png":
        data = encode_png(img)
    elif ext == ".bmp":
        data = encode_bmp(img)
    elif ext in (".tif", ".tiff"):
        data = encode_tiff(img)
    elif ext == ".webp":
        data = encode_webp(img)
    else:
        raise ValueError(f"{path}: could not find a writer for {ext or 'a file without a suffix'}"
                         "; the port writes .jpg, .jpeg, .png, .bmp, .tif, .tiff and .webp")
    with open(path, "wb") as f:
        f.write(data)
