"""The port's PNG reader and writer (yolov6_tpu_torch/data/image_io.py)
against cv2 and PIL, which the JAX package reads images with. PNG is
lossless, so the pixels must be equal exactly."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from yolov6_tpu_torch.data.image_io import image_size, imread, imwrite_png

# (h, w) or (h, w, c): grey, BGR, BGRA, odd widths, one-pixel rows and columns
CV2_SHAPES = [(7, 5), (31, 17), (7, 5, 3), (1, 17, 3), (33, 1, 3), (64, 97, 3), (9, 13, 4),
              (1, 1, 4), (40, 61, 4)]


def _image(shape, seed):
    """Random noise over a ramp, so that libpng's adaptive filtering picks
    more than one filter type."""
    rng = np.random.default_rng(seed)
    ramp = (np.arange(shape[1]) * 7 % 256).astype(np.uint8)
    ramp = ramp.reshape((1, shape[1]) + (1,) * (len(shape) - 2))
    return (rng.integers(0, 32, shape) + ramp).astype(np.uint8)


def _chunk(kind, payload):
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", zlib.crc32(kind + payload) & 0xFFFFFFFF)


def _filter_row(f, row, prev, bpp):
    """PNG filter ``f`` (0-4) of one row of bytes, as an encoder writes it."""
    row, prev = row.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if f == 0:
        pred = np.zeros_like(row)
    elif f == 1:
        pred = a
    elif f == 2:
        pred = prev
    elif f == 3:
        pred = (a + prev) >> 1
    else:
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
    return ((row - pred) % 256).astype(np.uint8)


def _encode_rows(px, filters):
    """Filtered scanlines of ``px`` (h, w, c) with filter ``filters[y % len]``."""
    h, w, c = px.shape
    out, prev = [], np.zeros(w * c, np.uint8)
    for y in range(h):
        row = px[y].reshape(-1)
        f = filters[y % len(filters)]
        out.append(bytes([f]) + _filter_row(f, row, prev, c).tobytes())
        prev = row
    return b"".join(out)


def _write_png(path, px, ctype, filters, depth=8, interlace=0):
    """A PNG encoded here, the scanline filters forced, optionally Adam7
    interlaced (each pass its own scanlines)."""
    h, w = px.shape[:2]
    if interlace:
        passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                  (1, 0, 2, 2), (0, 1, 1, 2)]
        data = b"".join(_encode_rows(px[y0::dy, x0::dx], filters)
                        for x0, y0, dx, dy in passes if px[y0::dy, x0::dx].size)
    else:
        data = _encode_rows(px, filters)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(data))
                + _chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", CV2_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_imread_equals_cv2_on_cv2_pngs(tmp_path, shape):
    img = _image(shape, seed=sum(shape))
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img)
    got, want = imread(path), cv2.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert image_size(path) == Image.open(path).size


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (6, 4)], ids=["grey", "rgb", "rgba"])
def test_imread_equals_cv2_for_each_filter(tmp_path, filters, ctype, channels):
    px = _image((11, 23, channels), seed=ctype)
    path = str(tmp_path / "f.png")
    _write_png(path, px, ctype, filters)
    want = cv2.imread(path)
    assert want is not None
    np.testing.assert_array_equal(imread(path), want)
    assert image_size(path) == Image.open(path).size == (23, 11)


@pytest.mark.parametrize("shape", [(5, 7), (6, 9, 3), (4, 3, 4)], ids=["grey", "bgr", "bgra"])
def test_imwrite_png_round_trips_through_cv2(tmp_path, shape):
    img = _image(shape, seed=3)
    path = str(tmp_path / "w.png")
    imwrite_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(imread(path), cv2.imread(path))


def test_unreadable_formats_raise_value_error(tmp_path):
    """GIF raises, naming the format and what the port reads; the kinds the
    port once refused (TIFF, WebP, progressive JPEG, BMP, 16-bit, Adam7 and
    palette PNG) decode to cv2's pixels (tests/test_torch_image_formats.py,
    test_torch_tiff.py and test_torch_webp.py have them all)."""
    img = _image((16, 16, 3), seed=4)
    path = str(tmp_path / "a.gif")
    Image.fromarray(img).save(path)
    with pytest.raises(ValueError, match=r"a\.gif: GIF file; the port reads PNG, JPEG \(MPO\), "
                                         r"BMP, TIFF \(DNG\) and WebP"):
        imread(path)
    with pytest.raises(ValueError, match="GIF"):
        image_size(path)
    for ext in (".tif", ".webp"):
        path = str(tmp_path / f"a{ext}")
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(imread(path), cv2.imread(path))
        assert image_size(path) == (16, 16)

    jpg, bmp = str(tmp_path / "a.jpg"), str(tmp_path / "a.bmp")
    assert cv2.imwrite(jpg, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]) and cv2.imwrite(bmp, img)
    deep = str(tmp_path / "deep.png")
    assert cv2.imwrite(deep, img.astype(np.uint16) * 257)
    assert cv2.imread(deep, cv2.IMREAD_UNCHANGED).dtype == np.uint16
    interlaced = str(tmp_path / "adam7.png")
    _write_png(interlaced, _image((13, 10, 3), seed=5), 2, [0], interlace=1)
    palette = str(tmp_path / "palette.png")
    Image.fromarray(img[:, :, 0]).convert("P").save(palette)
    for path in (jpg, bmp, deep, interlaced, palette):
        np.testing.assert_array_equal(imread(path), cv2.imread(path))
