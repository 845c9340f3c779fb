"""Writes the small image files of ``tests/data/torch_images/`` with cv2 and
PIL (and by hand where neither writes the kind), and ``hashes.json`` beside
them: for each file the shape and the SHA-256 of the pixels the JAX
package's ``load_image`` gets (``cv2.imread``, or its PIL branch where cv2
gives None), or, under ``refused``, the files it raises on; for each demo
JPEG the SHA-256 of ``cv2.imencode('.jpg', ...)``'s and
``cv2.imencode('.tif', ...)``'s bytes of its pixels. ``chip_smoke.py`` [35]
and [36] hold the port's decoders and encoders, built by the card machine's
compiler, to those hashes; ``tests/test_torch_image_formats.py``,
``test_torch_tiff.py``, ``test_torch_webp.py`` and
``test_torch_bmp_rle_cmyk.py`` hold the files to cv2 and PIL here. Run from
the repository root to rewrite them:

    python tests/torch_image_fixtures.py
"""

import hashlib
import io
import json
import os
import struct
import zlib

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "data", "torch_images")
DEMO_JPEGS = ("data/images/image1.jpg", "data/images/image2.jpg", "data/images/image3.jpg")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def smooth_image(h, w, seed, channels=3):
    """Noise under a blur: smooth areas and detail, and small files."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    img = cv2.addWeighted(cv2.GaussianBlur(noise, (0, 0), 3), 0.8, noise, 0.2, 0)
    return img.reshape(h, w, channels)


def png_chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def _png_row(row, depth):
    """One row of samples (W x C) packed at ``depth`` bits, MSB first."""
    if depth == 16:
        return row.astype(">u2").tobytes()
    flat = row.reshape(-1).astype(np.uint8)
    if depth == 8:
        return flat.tobytes()
    per = 8 // depth
    flat = np.concatenate([flat, np.zeros(-len(flat) % per, np.uint8)]).reshape(-1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(flat << shifts, axis=1).astype(np.uint8).tobytes()


def hand_png(px, ctype, depth=8, interlace=False):
    """A PNG of ``px`` (HxWxC samples as the colour type lays them out) at
    ``depth`` bits, Adam7-interlaced or not, every row unfiltered."""
    h, w = px.shape[:2]
    raw = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub:
            raw += b"\x00" + _png_row(row, depth)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", ihdr)
            + png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b""))


def adam7_png(px, ctype, depth=8):
    """``hand_png`` interlaced."""
    return hand_png(px, ctype, depth, interlace=True)


def bmp(px_rows, w, h, bpp, palette=b"", masks=None, top_down=False):
    """A BMP with a 40-byte DIB header: ``px_rows`` is the packed bytes of
    each row, top row first; ``masks`` (R, G, B) makes it BI_BITFIELDS."""
    stride = (w * bpp + 31) // 32 * 4
    rows = [r + b"\x00" * (stride - len(r)) for r in px_rows]
    data = b"".join(rows if top_down else rows[::-1])
    extra = struct.pack("<III", *masks) if masks else b""
    offset = 14 + 40 + len(extra) + len(palette)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, 3 if masks else 0,
                       len(data), 0, 0, len(palette) // 4, 0)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + extra
            + palette + data)


def last_scan_cut(data: bytes) -> bytes:
    """A progressive JPEG cut halfway into its last scan (no EOI): the
    coefficients' bits are all known, so libjpeg decodes it unsmoothed."""
    sos = data.rindex(b"\xff\xda")
    return data[:sos + (len(data) - sos) // 2]


def hand_tiff(w, h, tags, segments, le=True, big=False):
    """A TIFF (BigTIFF with ``big``) of one IFD: ``tags`` is ``[(tag, type,
    values)]`` (type 3 SHORT, 4 LONG, 7 UNDEFINED bytes, 1 BYTE); the
    ``segments`` (strip or tile bytes) are written after the header and
    their offsets and byte counts added under ``offsets_tag`` 273/279 or
    324/325 (taken from a ``("tiles",)`` marker in ``tags``)."""
    e = "<" if le else ">"
    tiled = any(t[0] == 322 for t in tags)
    head = 16 if big else 8
    offsets, pos, blob = [], head, b""
    for seg in segments:
        offsets.append(pos)
        blob += seg + b"\x00" * (len(seg) & 1)
        pos += len(seg) + (len(seg) & 1)
    tags = list(tags) + [(324 if tiled else 273, 4, offsets),
                         (325 if tiled else 279, 4, [len(x) for x in segments]),
                         (256, 4, [w]), (257, 4, [h])]
    tags.sort(key=lambda t: t[0])
    fmt = {1: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}
    size = {1: 1, 3: 2, 4: 4, 7: 1, 16: 8}
    entry, inline = (20, 8) if big else (12, 4)
    ifd_at = pos
    extra_at = ifd_at + (8 if big else 2) + entry * len(tags) + (8 if big else 4)
    ifd, extra = b"", b""
    for tag, typ, vals in tags:
        raw = bytes(vals) if typ == 7 else struct.pack(e + fmt[typ] * len(vals), *vals)
        if big:
            ifd += struct.pack(e + "HHQ", tag, typ, len(vals))
        else:
            ifd += struct.pack(e + "HHI", tag, typ, len(vals))
        if len(raw) > inline:
            ifd += struct.pack(e + ("Q" if big else "I"), extra_at + len(extra))
            extra += raw + b"\x00" * (len(raw) & 1)
        else:
            ifd += raw.ljust(inline, b"\x00")
    if big:
        header = (b"II" if le else b"MM") + struct.pack(e + "HHHQ", 43, 8, 0, ifd_at)
        ifd = struct.pack(e + "Q", len(tags)) + ifd + struct.pack(e + "Q", 0)
    else:
        header = (b"II" if le else b"MM") + struct.pack(e + "HI", 42, ifd_at)
        ifd = struct.pack(e + "H", len(tags)) + ifd + struct.pack(e + "I", 0)
    return header + blob + ifd + extra


def jpeg_tables_split(data: bytes):
    """A JPEG split as a JPEG-compressed TIFF stores it: the tables stream
    (SOI, DQT and DHT segments, EOI) and the image stream without them."""
    tables, image, pos = b"\xff\xd8", b"\xff\xd8", 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xDA:
            image += data[pos:]
            break
        n = struct.unpack_from(">H", data, pos + 2)[0]
        seg = data[pos:pos + 2 + n]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif marker != 0xE0:
            image += seg
        pos += 2 + n
    return tables + b"\xff\xd9", image


def rle_bmp(w, h, bpp, stream, palette):
    """An RLE8 (``bpp`` 8) or RLE4 (4) BMP of the ``stream`` of codes."""
    off = 14 + 40 + len(palette)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 1 if bpp == 8 else 2, len(stream), 0, 0,
                       len(palette) // 4, 0)
    return b"BM" + struct.pack("<IHHI", off + len(stream), 0, 0, off) + info + palette + stream


def rle8_stream(idx):
    """Rows (bottom row first, as stored) coded with each RLE8 kind: a run
    of equal indices as an encoded run, three or more others as an
    absolute run (odd lengths padded), a row of index 0 skipped by a delta,
    the last row's tail left to end-of-bitmap."""
    out, h = b"", len(idx)
    rows = idx[::-1]
    y = 0
    while y < h:
        row = list(rows[y])
        if y + 1 < h and not any(row) and y > 0:
            out += bytes([0, 2, 0, 1])  # delta: one row on, same column
            y += 1
            continue
        x = 0
        last = y == h - 1
        while x < len(row):
            if last and not any(row[x:]):
                break
            run = 1
            while x + run < len(row) and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 2 or len(row) - x < 3:
                out += bytes([run, row[x]])
                x += run
                continue
            n = 3
            while x + n < len(row) and n < 255 and row[x + n] != row[x + n - 1]:
                n += 1
            out += bytes([0, n]) + bytes(row[x:x + n]) + (b"\x00" if n & 1 else b"")
            x += n
        if not last:
            out += b"\x00\x00"
        y += 1
    return out + b"\x00\x01"


def rle4_stream(idx):
    """Rows (bottom first) coded in RLE4: two-nibble encoded runs, absolute
    runs of an odd and an even count, a delta over a row's leading zeros
    (OpenCV steps an RLE4 delta over dx only), an end-of-line after every
    row, end-of-bitmap at the end."""
    out, h = b"", len(idx)
    rows = idx[::-1]
    for y in range(h):
        row = list(rows[y])
        x = 0
        lead = next((i for i, v in enumerate(row) if v), len(row))
        if 2 <= lead < len(row):
            out += bytes([0, 2, lead, 0])
            x = lead
        while x < len(row):
            if x % 7 == 0 and len(row) - x >= 5:
                n = 5 if y % 2 else 4
                nib = row[x:x + n] + [0]
                packed = bytes((nib[i] << 4) | nib[i + 1] for i in range(0, n, 2))
                out += bytes([0, n]) + packed + (b"\x00" if len(packed) & 1 else b"")
                x += n
                continue
            run = 2 if len(row) - x >= 2 and row[x + 1] == row[x] else 1
            pair = (row[x] << 4) | (row[x + 1] if run == 2 else 0)
            out += bytes([run, pair])
            x += run
        out += b"\x00\x00"
    return out + b"\x00\x01"


def jax_read(path):
    """What the JAX package's ``load_image`` reads: ``cv2.imread``, then
    its PIL branch; None where that raises or gives an image that is not
    8-bit (a float TIFF), which the port refuses."""
    img = cv2.imread(path)
    if img is not None:
        return img
    try:
        img = cv2.cvtColor(np.asarray(Image.open(path)), cv2.COLOR_RGB2BGR)
    except Exception:
        return None
    return img if img.dtype == np.uint8 else None


def format_fixtures():
    """The TIFF, DNG, WebP, MPO, RLE BMP, CMYK/YCCK JPEG and PNG ``eXIf``
    fixtures: ``{name: bytes}``."""
    files = {}
    rgb = np.ascontiguousarray(smooth_image(23, 31, 17)[:, :, ::-1])
    grey = rgb[:, :, 0]

    def pil(name, im, **kw):
        buf = io.BytesIO()
        im.save(buf, **kw)
        files[name] = buf.getvalue()

    pil("tif_none_rgb.tif", Image.fromarray(rgb), format="TIFF")
    pil("tif_lzw_rgb.tif", Image.fromarray(rgb), format="TIFF", compression="tiff_lzw")
    pil("tif_packbits.tif", Image.fromarray(rgb), format="TIFF", compression="packbits")
    pil("tif_deflate.tif", Image.fromarray(rgb), format="TIFF", compression="tiff_adobe_deflate")
    pil("tif_jpeg_rgb.tif", Image.fromarray(rgb), format="TIFF", compression="jpeg")
    pil("tif_g4.tif", Image.fromarray(grey > 120), format="TIFF", compression="group4")
    pil("tif_g3.tif", Image.fromarray(grey > 120), format="TIFF", compression="group3")
    pil("tif_pal8.tif", Image.fromarray(rgb).quantize(60), format="TIFF")
    pil("tif_pal4.tif", Image.fromarray(rgb).quantize(16), format="TIFF", bits=4)
    pil("tif_rgba.tif", Image.fromarray(np.dstack([rgb, grey[::-1]]), "RGBA"), format="TIFF",
        compression="tiff_lzw")
    pil("tif_cmyk.tif", Image.fromarray(np.dstack([rgb, grey[:, ::-1]]), "CMYK"), format="TIFF")
    pil("tif_orient6.tif", Image.fromarray(rgb), format="TIFF", tiffinfo={274: 6})
    pil("tif_orient3.tif", Image.fromarray(rgb), format="TIFF", tiffinfo={274: 3})
    pil("tif_float.tif", Image.fromarray(grey.astype(np.float32) / 255), format="TIFF")
    files["tif_lzw_pred.tif"] = cv2.imencode(".tif", rgb[:, :, ::-1])[1].tobytes()
    deep = (rgb.astype(np.uint16) * 257 + np.arange(31, dtype=np.uint16)[None, :, None])
    files["tif_lzw_pred16.tif"] = cv2.imencode(".tif", deep[:, :, ::-1])[1].tobytes()
    files["tif_grey16_mm.tif"] = hand_tiff(31, 23, [(258, 3, [16]), (259, 3, [1]), (262, 3, [1]),
                                                    (277, 3, [1])],
                                           [deep[:, :, 0].astype(">u2").tobytes()], le=False)
    h, w = grey.shape
    for bits in (2, 4):
        vals = (grey >> (8 - bits)).astype(np.uint8)
        per = 8 // bits
        padded = np.concatenate([vals, np.zeros((h, -w % per), np.uint8)], axis=1)
        packed = np.bitwise_or.reduce(padded.reshape(h, -1, per) << np.arange(
            8 - bits, -1, -bits, dtype=np.uint8), axis=2).astype(np.uint8)
        files[f"tif_grey{bits}.tif"] = hand_tiff(w, h, [(258, 3, [bits]), (259, 3, [1]),
                                                        (262, 3, [1]), (277, 3, [1])],
                                                 [packed.tobytes()])
    bw = np.packbits(grey > 100, axis=1)
    files["tif_bw_miniswhite.tif"] = hand_tiff(w, h, [(258, 3, [1]), (259, 3, [1]),
                                                      (262, 3, [0]), (277, 3, [1])],
                                               [bw.tobytes()])
    rgba = np.dstack([rgb, grey[::-1]])
    files["tif_rgba_assoc.tif"] = hand_tiff(w, h, [(258, 3, [8] * 4), (259, 3, [8]), (262, 3, [2]),
                                                   (277, 3, [4]), (338, 3, [1])],
                                            [zlib.compress(rgba.tobytes())])
    tw = th = 16
    tiles = []
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            tile = np.zeros((th, tw, 3), np.uint8)
            part = rgb[ty:ty + th, tx:tx + tw]
            tile[:part.shape[0], :part.shape[1]] = part
            tiles.append(zlib.compress(tile.tobytes()))
    files["tif_tiles.tif"] = hand_tiff(w, h, [(258, 3, [8] * 3), (259, 3, [32946]),
                                              (262, 3, [2]), (277, 3, [3]), (322, 3, [tw]),
                                              (323, 3, [th])], tiles)
    planes = [zlib.compress(np.ascontiguousarray(rgb[:12, :, c]).tobytes()) for c in range(3)]
    planes += [zlib.compress(np.ascontiguousarray(rgb[12:, :, c]).tobytes()) for c in range(3)]
    planes = [planes[0], planes[3], planes[1], planes[4], planes[2], planes[5]]
    files["tif_planar2.tif"] = hand_tiff(w, h, [(258, 3, [8] * 3), (259, 3, [8]), (262, 3, [2]),
                                                (277, 3, [3]), (278, 3, [12]), (284, 3, [2])],
                                         planes)
    files["tif_bigtiff.tif"] = hand_tiff(w, h, [(258, 3, [8] * 3), (259, 3, [1]), (262, 3, [2]),
                                                (277, 3, [3])], [rgb.tobytes()], big=True)
    tables, image = jpeg_tables_split(cv2.imencode(".jpg", rgb[:, :, ::-1])[1].tobytes())
    files["tif_jpeg_ycbcr.tif"] = hand_tiff(w, h, [(258, 3, [8] * 3), (259, 3, [7]),
                                                   (262, 3, [6]), (277, 3, [3]),
                                                   (347, 7, list(tables)), (530, 3, [2, 2])],
                                            [image])
    raw = (deep[:, :, 1] >> 4).astype("<u2")
    cfa_tags = [(254, 4, [0]), (258, 3, [16]), (259, 3, [1]), (262, 3, [32803]), (277, 3, [1]),
                (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2])]
    files["dng_preview.dng"] = dng_with_subifd(np.ascontiguousarray(rgb[::2, ::2]), raw, cfa_tags)
    files["dng_cfa.dng"] = hand_tiff(w, h, cfa_tags + [(50706, 1, [1, 4, 0, 0])], [raw.tobytes()])

    img = rgb[:, :, ::-1]
    files["webp_lossy.webp"] = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 80])[1]
    files["webp_lossless.webp"] = cv2.imencode(".webp", img)[1]
    pil("webp_lossy_alpha.webp", Image.fromarray(rgba, "RGBA"), format="WEBP", quality=70)
    pil("webp_lossless_alpha.webp", Image.fromarray(rgba, "RGBA"), format="WEBP", lossless=True,
        exact=True)
    for ncol in (2, 4, 16, 200):  # colour indexing, pixel bundling at 8, 4, 2 and 1 a byte
        pil(f"webp_palette{ncol}.webp", Image.fromarray(rgb).quantize(ncol).convert("RGB"),
            format="WEBP", lossless=True)
    ex = Image.Exif()
    ex[274] = 6
    pil("webp_exif6.webp", Image.fromarray(rgb), format="WEBP", quality=90, exif=ex.tobytes())
    pil("webp_anim.webp", Image.fromarray(rgb), format="WEBP", save_all=True,
        append_images=[Image.fromarray(rgb[::-1].copy())], lossless=True, duration=100)
    files["webp_anim_offset.webp"] = offset_animation(rgb)
    pil("mpo.mpo", Image.fromarray(rgb), format="MPO", save_all=True,
        append_images=[Image.fromarray(rgb[::-1].copy())])
    pal = b"".join(bytes([(i * 37) % 256, (i * 91) % 256, (i * 13 + 50) % 256, 0])
                   for i in range(256))
    idx8 = (grey // 32).astype(np.uint8) + 1
    idx8[8:10] = 0
    idx8[-1, 10:] = 0
    files["bmp_rle8.bmp"] = rle_bmp(w, h, 8, rle8_stream(idx8), pal)
    idx4 = (grey // 64).astype(np.uint8) + 1
    idx4[6] = 0
    files["bmp_rle4.bmp"] = rle_bmp(w, h, 4, rle4_stream(idx4), pal[:64])
    cmyk = np.dstack([rgb, grey[:, ::-1]])
    pil("jpeg_cmyk.jpg", Image.fromarray(cmyk, "CMYK"), format="JPEG", quality=90)
    ycck = bytearray(files["jpeg_cmyk.jpg"])
    adobe = ycck.index(b"Adobe")
    ycck[adobe + 11] = 2  # the same samples read as YCCK
    files["jpeg_ycck.jpg"] = bytes(ycck)
    small = rgb[:9, :13]
    for o in range(1, 9):
        ex = Image.Exif()
        ex[274] = o
        pil(f"png_exif{o}.png", Image.fromarray(small), format="PNG", exif=ex.tobytes())
    files["png_exif6_after_idat.png"] = exif_after_idat(files["png_exif6.png"])
    return files


def _ifd(tags, at):
    """One little-endian IFD written at ``at``: its bytes, the values that
    do not fit an entry after it."""
    fmt = {1: "B", 3: "H", 4: "I", 7: "B"}
    tags = sorted(tags, key=lambda t: t[0])
    extra_at = at + 2 + 12 * len(tags) + 4
    ifd, extra = struct.pack("<H", len(tags)), b""
    for tag, typ, vals in tags:
        raw = bytes(vals) if typ == 7 else struct.pack("<" + fmt[typ] * len(vals), *vals)
        ifd += struct.pack("<HHI", tag, typ, len(vals))
        if len(raw) > 4:
            ifd += struct.pack("<I", extra_at + len(extra))
            extra += raw + b"\x00" * (len(raw) & 1)
        else:
            ifd += raw.ljust(4, b"\x00")
    return ifd + struct.pack("<I", 0) + extra


def dng_with_subifd(preview, raw, cfa_tags):
    """A DNG as cameras write one: IFD0 an 8-bit RGB preview (NewSubfileType
    1) with DNGVersion and a SubIFDs tag (330) naming the CFA raw's IFD."""
    ph, pw = preview.shape[:2]
    h, w = raw.shape
    p_at, r_at = 8, 8 + preview.nbytes
    ifd0_at = r_at + raw.nbytes
    ifd0_tags = [(254, 4, [1]), (256, 4, [pw]), (257, 4, [ph]), (258, 3, [8] * 3), (259, 3, [1]),
                 (262, 3, [2]), (273, 4, [p_at]), (277, 3, [3]), (279, 4, [preview.nbytes]),
                 (50706, 1, [1, 4, 0, 0])]
    size0 = len(_ifd(ifd0_tags + [(330, 4, [0])], ifd0_at))
    sub_at = ifd0_at + size0
    ifd0 = _ifd(ifd0_tags + [(330, 4, [sub_at])], ifd0_at)
    sub = _ifd(cfa_tags + [(256, 4, [w]), (257, 4, [h]), (273, 4, [r_at]),
                           (279, 4, [raw.nbytes])], sub_at)
    return (b"II*\x00" + struct.pack("<I", ifd0_at) + preview.tobytes() + raw.tobytes() + ifd0
            + sub)


def offset_animation(rgb):
    """An animated WebP whose first frame (lossless) is smaller than the
    canvas, at offset (4, 6); its second covers the canvas."""
    def chunk(kind, payload):
        return kind + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)

    def u24(v):
        return v.to_bytes(3, "little")

    def frame(im):
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="WEBP", lossless=True)
        return buf.getvalue()[12:]

    h, w = rgb.shape[:2]
    first = rgb[:10, :12].copy()
    anmf1 = u24(2) + u24(3) + u24(11) + u24(9) + u24(100) + b"\x00" + frame(first)
    anmf2 = u24(0) + u24(0) + u24(w - 1) + u24(h - 1) + u24(100) + b"\x00" + frame(rgb[::-1].copy())
    body = (b"WEBP" + chunk(b"VP8X", b"\x12\x00\x00\x00" + u24(w - 1) + u24(h - 1))
            + chunk(b"ANIM", b"\x00" * 6) + chunk(b"ANMF", anmf1) + chunk(b"ANMF", anmf2))
    return b"RIFF" + struct.pack("<I", len(body)) + body


def exif_after_idat(png: bytes) -> bytes:
    """The PNG with its ``eXIf`` chunk moved after the image data."""
    i = png.index(b"eXIf") - 4
    n = struct.unpack_from(">I", png, i)[0]
    chunk = png[i:i + 12 + n]
    rest = png[:i] + png[i + 12 + n:]
    end = rest.index(b"IEND") - 4
    return rest[:end] + chunk + rest[end:]


def write_fixtures(out=FIXTURES):
    """Write every fixture into ``out``; returns the names."""
    os.makedirs(out, exist_ok=True)
    files = {}
    img = smooth_image(53, 75, 1)
    files["prog_420.jpg"] = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
    files["prog_grey.jpg"] = cv2.imencode(".jpg", smooth_image(37, 41, 2)[:, :, 0],
                                          [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
    base = cv2.imencode(".jpg", smooth_image(61, 93, 3))[1].tobytes()
    files["trunc_420.jpg"] = base[:len(base) * 3 // 5]
    prog = cv2.imencode(".jpg", smooth_image(47, 67, 4), [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])[1].tobytes()
    files["trunc_prog_last_scan.jpg"] = last_scan_cut(prog)
    rng = np.random.default_rng(5)
    deep = smooth_image(29, 37, 5).astype(np.uint16) * 257 + rng.integers(0, 256, (29, 37, 3),
                                                                          dtype=np.uint16)
    files["rgb16.png"] = cv2.imencode(".png", deep)[1]
    rgb = smooth_image(31, 45, 6)[:, :, ::-1]
    for name, im, kw in (
            ("palette4.png", Image.fromarray(rgb).quantize(16), dict(bits=4)),
            ("palette8.png", Image.fromarray(rgb).quantize(200), {}),
            ("grey_alpha.png", Image.fromarray(np.dstack([rgb[:, :, 0], rgb[:, :, 1]]), "LA"),
             {}),
            ("grey1.png", Image.fromarray(rgb[:, :, 0] > 128), {}),
            ("bmp1.bmp", Image.fromarray(rgb[:, :, 0] > 128), {}),
            ("bmp8.bmp", Image.fromarray(rgb).quantize(64), {}),
            ("bmp24.bmp", Image.fromarray(rgb), {}),
            ("bmp32.bmp", Image.fromarray(np.dstack([rgb, rgb[:, :, :1]]), "RGBA"), {})):
        path = os.path.join(out, name)
        im.save(path, **kw)
        with open(path, "rb") as f:
            files[name] = f.read()
    files["adam7_rgb.png"] = adam7_png(smooth_image(21, 27, 7), 2)
    files["grey2.png"] = hand_png(rgb[:, :, :1] >> 6, 0, 2)
    files["grey4_adam7.png"] = hand_png(rgb[:, :, 1:2] >> 4, 0, 4, interlace=True)
    w, h = 13, 9
    px = smooth_image(h, w, 8)
    v565 = ((px[:, :, 2].astype(np.uint16) >> 3) << 11 | (px[:, :, 1].astype(np.uint16) >> 2) << 5
            | px[:, :, 0].astype(np.uint16) >> 3)
    files["bmp565.bmp"] = bmp([r.astype("<u2").tobytes() for r in v565], w, h, 16,
                              masks=(0xF800, 0x07E0, 0x001F))
    idx = (px[:, :, 0] >> 4).astype(np.uint8)
    pal = b"".join(bytes([i * 16, 255 - i * 16, i * 8, 0]) for i in range(16))
    packed = [bytes((a << 4) | b for a, b in zip(r[0::2], np.append(r[1::2], 0)[:len(r[0::2])]))
              for r in idx]
    files["bmp4_top_down.bmp"] = bmp(packed, w, h, 4, palette=pal, top_down=True)

    files.update(format_fixtures())
    # a lossy 640x640 WebP of a demo JPEG's pixels (mirrored out to square): the
    # infer CLI's source and the lossy decoder's timing in chip_smoke.py [36]
    demo = cv2.imread(os.path.join(REPO_ROOT, DEMO_JPEGS[1]))
    square = np.concatenate([demo, demo[:, ::-1][:, :640 - demo.shape[1]]], axis=1)
    files["infer_source.webp"] = cv2.imencode(".webp", square, [cv2.IMWRITE_WEBP_QUALITY, 75])[1]

    manifest = {"images": {}, "encoded": {}, "encoded_tiff": {}, "refused": []}
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(bytes(data))
        want = jax_read(path)
        if want is None:
            manifest["refused"].append(name)
            continue
        manifest["images"][name] = dict(shape=list(want.shape),
                                        sha256=hashlib.sha256(want.tobytes()).hexdigest())
    for rel in DEMO_JPEGS:
        img = cv2.imread(os.path.join(REPO_ROOT, rel))
        data = cv2.imencode(".jpg", img)[1].tobytes()
        manifest["encoded"][rel] = dict(bytes=len(data), sha256=hashlib.sha256(data).hexdigest())
        data = cv2.imencode(".tif", img)[1].tobytes()
        manifest["encoded_tiff"][rel] = dict(bytes=len(data),
                                             sha256=hashlib.sha256(data).hexdigest())
    with open(os.path.join(out, "hashes.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return sorted(files)


if __name__ == "__main__":
    print("\n".join(write_fixtures()))
