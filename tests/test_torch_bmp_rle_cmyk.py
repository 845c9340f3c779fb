"""The port's RLE BMP reader (yolov6_tpu_torch/data/image_io.py) and CMYK/YCCK
JPEG decoding and restore (data/csrc/jpeg_decode.cc, jpeg_encode.cc,
data/datasets.py::restore_jpeg) against the JAX package: ``cv2.imread``'s
pixels (OpenCV's grfmt_bmp.cpp; libjpeg-turbo's CMYK and YCCK->CMYK, then
OpenCV's inverted-CMYK->BGR), ``check_image``'s shape, message and format,
and the file ``check_image`` restores from a truncated CMYK JPEG (PIL's
CMYK JPEG at quality 100).

Tolerance: none: pixels and restored bytes are equal.
"""

import os
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.data.datasets import check_image as jax_check_image

from yolov6_tpu_torch.data.datasets import check_image
from yolov6_tpu_torch.data.image_io import image_format, image_size, imread

from torch_image_fixtures import FIXTURES, rle4_stream, rle8_stream, rle_bmp, smooth_image

PALETTE = b"".join(bytes([(i * 37) % 256, (i * 91) % 256, (i * 13 + 50) % 256, 0])
                   for i in range(256))


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _same_as_cv2(path):
    want = cv2.imread(path)
    assert want is not None, path
    got = imread(path)
    assert got.shape == want.shape and np.array_equal(got, want), path


@pytest.mark.parametrize("name", ["bmp_rle8.bmp", "bmp_rle4.bmp"])
def test_rle_fixtures(name):
    path = os.path.join(FIXTURES, name)
    _same_as_cv2(path)
    for full in (False, True):
        assert check_image(path, full) == (tuple(jax_check_image(path, full)[0]), "")
    assert image_format(path) == "bmp"


@pytest.mark.parametrize("hw", [(1, 1), (2, 5), (9, 13), (23, 31), (40, 64)],
                         ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("bpp", [8, 4])
def test_rle_streams_of_every_kind(tmp_path, hw, bpp):
    """Encoded and absolute runs (odd and even, with their word padding),
    end-of-line after full and short rows, deltas (RLE8: over blank rows;
    RLE4: over a row's leading zeros) and end-of-bitmap before the last
    pixels, on random, smooth and sparse indices."""
    rng = np.random.default_rng(hw[0] * 5 + hw[1] + bpp)
    top = 256 if bpp == 8 else 16
    for k, idx in enumerate([rng.integers(0, top, hw).astype(np.uint8),
                             (smooth_image(*hw, seed=bpp)[:, :, 0] * (top - 1) // 255)
                             .astype(np.uint8),
                             np.where(rng.random(hw) < 0.7, 0, rng.integers(1, top, hw))
                             .astype(np.uint8)]):
        if hw[0] > 2:
            idx[hw[0] // 2] = 0  # a blank row
        stream = (rle8_stream if bpp == 8 else rle4_stream)(idx)
        path = _write(tmp_path, f"r{k}.bmp", rle_bmp(hw[1], hw[0], bpp, stream,
                                                   PALETTE[:4 * top]))
        _same_as_cv2(path)
        assert image_size(path) == (hw[1], hw[0])


RLE8_CASES = {  # code streams on a 6x4 RLE8 image, each escape and its edge cases
    "runs_abs_eol_delta_eob": bytes([3, 5, 0, 3, 1, 2, 3, 0, 0, 0, 2, 7, 0, 2, 1, 1, 2, 9,
                                     0, 1]),
    "wrap_then_eol_skipped": bytes([6, 4, 0, 0, 6, 5, 0, 1]),
    "eol_twice": bytes([3, 4, 0, 0, 0, 0, 2, 7, 0, 1]),
    "full_row_eol_twice": bytes([6, 4, 0, 0, 0, 0, 2, 7, 0, 1]),
    "delta_first": bytes([0, 2, 1, 2, 3, 9, 0, 1]),
    "eob_first": bytes([0, 1]),
    "run_past_the_row": bytes([8, 4, 2, 6, 0, 1]),
    "abs_past_the_row": bytes([2, 3, 0, 5, 1, 2, 3, 4, 5, 0, 0, 1]),
    "no_eob": bytes([6, 4, 3, 5]),
}
RLE4_CASES = {
    "rows_with_eol": bytes([6, 0x12, 0, 0, 6, 0x34, 0, 0, 6, 0x56, 0, 0, 6, 0x78, 0, 0, 0, 1]),
    "abs_odd_and_eob_mid_row": bytes([5, 0x12, 0, 0, 0, 3, 0x34, 0x50, 0, 0, 0, 1, 0, 0, 0, 0]),
    "delta_steps_dx_only": bytes([8, 0x12, 0, 0, 0, 2, 2, 1, 6, 0x56, 0, 0, 0, 1]),
    "eol_twice": bytes([3, 0x12, 0, 0, 0, 0, 2, 0x77, 0, 1, 0, 0]),
    "run_past_the_row": bytes([8, 0x12, 2, 0x33, 0, 1]),
    "full_row_no_eol": bytes([6, 0x12, 2, 0x33, 0, 1]),
}


@pytest.mark.parametrize("bpp,case", [(8, k) for k in RLE8_CASES] + [(4, k) for k in RLE4_CASES])
def test_rle_escapes_as_opencv(tmp_path, bpp, case):
    """Skipped pixels are palette entry 0; an RLE8 run wraps and skips the
    end-of-line after it; an RLE4 delta steps over dx only; a run past
    its row or a stream without end-of-bitmap gives cv2's None, which the
    JAX package's PIL branch raises on (a palette image): ValueError."""
    w, h = (8, 3) if case == "delta_steps_dx_only" else (6, 4)
    stream = (RLE8_CASES if bpp == 8 else RLE4_CASES)[case]
    path = _write(tmp_path, f"{case}.bmp", rle_bmp(w, h, bpp, stream,
                                                   PALETTE[:4 * (256 if bpp == 8 else 16)]))
    if cv2.imread(path) is None:
        with pytest.raises(ValueError, match=rf"{case}\.bmp: RLE{bpp} BMP"):
            imread(path)
        with pytest.raises(Exception):
            cv2.cvtColor(np.asarray(Image.open(path)), cv2.COLOR_RGB2BGR)
    else:
        _same_as_cv2(path)
        if case == "runs_abs_eol_delta_eob":  # the skipped pixels: palette entry 0
            assert (imread(path) == np.frombuffer(PALETTE[:3], np.uint8)).all(axis=2).sum() == 14


def _cmyk_jpeg(tmp_path, name, hw, seed, **kw):
    rgb = smooth_image(*hw, seed=seed)
    cmyk = np.dstack([rgb, rgb[:, :, 1][:, ::-1]])
    path = str(tmp_path / name)
    Image.fromarray(cmyk, "CMYK").save(path, "JPEG", **kw)
    return path


def _as_ycck(path):
    """The same samples read as YCCK: the Adobe marker's transform set to 2."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[data.index(b"Adobe") + 11] = 2
    out = path.replace(".jpg", "_ycck.jpg")
    with open(out, "wb") as f:
        f.write(bytes(data))
    return out


def _without_adobe(path):
    with open(path, "rb") as f:
        data = f.read()
    i = data.index(b"\xff\xee")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    out = path.replace(".jpg", "_plain.jpg")
    with open(out, "wb") as f:
        f.write(data[:i] + data[i + 2 + n:])
    return out


@pytest.mark.parametrize("hw", [(1, 1), (8, 8), (17, 29), (61, 97)],
                         ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_cmyk_and_ycck_jpegs_equal_cv2(tmp_path, hw):
    """PIL's CMYK JPEG (Adobe transform 0, inverted samples) at several
    qualities, 4:4:4 and subsampled, baseline and progressive; the same
    files read as YCCK; one without its Adobe marker (plain CMYK)."""
    for k, kw in enumerate([dict(quality=90), dict(quality=30, subsampling=2),
                            dict(quality=75, progressive=True), dict(quality=100)]):
        path = _cmyk_jpeg(tmp_path, f"c{k}.jpg", hw, seed=k + hw[0], **kw)
        for p in (path, _as_ycck(path), _without_adobe(path)):
            _same_as_cv2(p)
            assert image_size(p) == (hw[1], hw[0]) and image_format(p) == "jpeg"


@pytest.mark.parametrize("name", ["jpeg_cmyk.jpg", "jpeg_ycck.jpg"])
def test_cmyk_fixtures_check_as_jax(name):
    path = os.path.join(FIXTURES, name)
    _same_as_cv2(path)
    for full in (False, True):
        assert check_image(path, full) == (tuple(jax_check_image(path, full)[0]), "")


@pytest.mark.parametrize("kind", ["cmyk", "ycck", "plain"])
def test_truncated_cmyk_is_restored_as_jax_restores_it(tmp_path, kind):
    """``check_image`` with the full check rewrites a CMYK JPEG that lacks
    EOI as PIL does: a quality-100 CMYK JPEG of libjpeg's samples, byte for
    byte the file the JAX package writes."""
    src = _cmyk_jpeg(tmp_path, "src.jpg", (40, 56), seed=7, quality=85)
    src = {"cmyk": src, "ycck": _as_ycck(src), "plain": _without_adobe(src)}[kind]
    with open(src, "rb") as f:
        data = f.read()
    ours, theirs = str(tmp_path / "ours.jpg"), str(tmp_path / "theirs.jpg")
    for p in (ours, theirs):
        with open(p, "wb") as f:
            f.write(data[:len(data) * 2 // 3])
    shape, msg = check_image(ours, full_check=True)
    shape_j, msg_j = jax_check_image(theirs, full_check=True)
    assert shape == tuple(shape_j) == (56, 40) and "restored" in msg and "restored" in msg_j
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    _same_as_cv2(ours)
    shutil.copy(ours, str(tmp_path / "again.jpg"))
    assert check_image(str(tmp_path / "again.jpg"), full_check=True) == ((56, 40), "")
