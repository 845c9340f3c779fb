"""Writes the small image files of ``tests/data/torch_images/`` with cv2 and
PIL, and ``hashes.json`` beside them: for each file the shape and the
SHA-256 of ``cv2.imread``'s pixels, and for each demo JPEG the SHA-256 of
``cv2.imencode('.jpg', cv2.imread(path))``'s bytes. ``chip_smoke.py`` [35]
holds the port's decoders and encoder, built by the card machine's
compiler, to those hashes; ``tests/test_torch_image_formats.py`` holds the
files to cv2 here. Run from the repository root to rewrite them:

    python tests/torch_image_fixtures.py
"""

import hashlib
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

    manifest = {"images": {}, "encoded": {}}
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(bytes(data))
        want = cv2.imread(path)
        assert want is not None, name
        manifest["images"][name] = dict(shape=list(want.shape),
                                        sha256=hashlib.sha256(want.tobytes()).hexdigest())
    for rel in DEMO_JPEGS:
        data = cv2.imencode(".jpg", cv2.imread(os.path.join(REPO_ROOT, rel)))[1].tobytes()
        manifest["encoded"][rel] = dict(bytes=len(data), sha256=hashlib.sha256(data).hexdigest())
    with open(os.path.join(out, "hashes.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return sorted(files)


if __name__ == "__main__":
    print("\n".join(write_fixtures()))
