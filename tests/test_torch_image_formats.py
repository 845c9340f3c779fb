"""The port's readers (yolov6_tpu_torch/data/image_io.py, data/jpeg.py)
against ``cv2.imread`` on the formats the JAX package reads through cv2 and
PIL: progressive and truncated JPEG, the PNG kinds beyond 8-bit
grey/RGB/RGBA, and BMP. Every format here is lossless or decoded bit-exactly
by cv2's libjpeg-turbo pipeline, so the pixels must be equal
(``np.array_equal``), and ``image_size`` must give cv2's (w, h).

The files are written here by cv2 and PIL from seeded numpy images, or by
hand (Adam7 PNG, 4-bit, 16-bit and top-down BMP), or are the committed
fixtures of ``tests/data/torch_images/`` (``torch_image_fixtures.py``),
whose cv2 hashes ``chip_smoke.py`` [35] checks on the card."""

import hashlib
import io
import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from yolov6_tpu_torch.data import jpeg
from yolov6_tpu_torch.data.image_io import image_size, imread

from torch_image_fixtures import (
    FIXTURES, adam7_png, bmp, hand_png, jax_read, last_scan_cut, smooth_image,
)

PROGRESSIVE = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
SAMPLING = {"444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
            "420": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
            "grey": []}
ODD_SIZES = [(1, 1), (7, 13), (61, 97), (120, 161)]


def _same_as_cv2(path):
    want = cv2.imread(path)
    assert want is not None, path
    got = imread(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    assert got.shape == want.shape and np.array_equal(got, want), path
    assert image_size(path) == (want.shape[1], want.shape[0])


def _jpeg(h, w, sampling, progressive, seed):
    img = smooth_image(h, w, seed)
    if sampling == "grey":
        img = img[:, :, 0]
    return cv2.imencode(".jpg", img, SAMPLING[sampling] + (PROGRESSIVE if progressive else []))[
        1].tobytes()


@pytest.mark.parametrize("hw", ODD_SIZES, ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_cv2_jpegs_and_their_truncations(tmp_path, hw, sampling, progressive):
    """The whole file, its half and its quarter (libjpeg-turbo leaves the
    blocks past the end at zero coefficients: 128 grey). A progressive file
    cut before its last scan is one libjpeg block-smooths: it decodes
    smoothed as cv2 decodes it (once a ValueError); cut inside its last scan
    it decodes unsmoothed."""
    data = _jpeg(*hw, sampling, progressive, seed=hw[0] * 7 + hw[1])
    cuts = {"whole": data, "half": data[:len(data) // 2], "quarter": data[:len(data) // 4]}
    if progressive:
        cuts["last_scan"] = last_scan_cut(data)
    smoothed = 0
    for name, cut in cuts.items():
        path = str(tmp_path / f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(cut)
        if cv2.imread(path) is None:  # ends in a header: libjpeg fails too
            with pytest.raises(ValueError, match="JPEG file"):
                imread(path)
        elif progressive and name in ("half", "quarter"):
            _same_as_cv2(path)
            smoothed += 1
        else:
            _same_as_cv2(path)
    if progressive and hw[0] >= 61:  # both cuts land in the scans' data
        assert smoothed == 2


def test_truncated_jpeg_is_grey_past_the_end_and_warns(tmp_path, monkeypatch):
    """The warning goes to the module's logger (the package's logger does not
    propagate to the root once ``utils/events.py`` is imported, so it is
    read off the logger itself)."""
    data = _jpeg(64, 96, "420", False, seed=11)
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(data[:len(data) // 3])
    warned = []
    monkeypatch.setattr(jpeg.LOGGER, "warning", lambda msg, *a, **kw: warned.append(msg))
    img = imread(path)
    assert len(warned) == 1 and "premature end of JPEG file" in warned[0]  # once a decode
    _same_as_cv2(path)
    assert (img[-8:] == 128).all()  # the last MCU row: zero coefficients


def _pil_png(tmp_path, name, im, **kw):
    path = str(tmp_path / name)
    im.save(path, **kw)
    return path


@pytest.mark.parametrize("hw", [(1, 1), (5, 3), (31, 45)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_pil_png_kinds(tmp_path, hw):
    """Palette (8, 4, 2 and 1 bits, with and without tRNS), 16-bit grey
    and RGB(A), grey+alpha, grey at 1, 2 and 4 bits."""
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    rgb = smooth_image(*hw, seed=hw[1])[:, :, ::-1]
    pil = Image.fromarray(rgb)
    paths = [_pil_png(tmp_path, f"p{bits}.png", pil.quantize(2 ** bits), bits=bits)
             for bits in (1, 2, 4)]
    paths.append(_pil_png(tmp_path, "p8.png", pil.quantize(200)))
    paths.append(_pil_png(tmp_path, "p8t.png", pil.quantize(60), transparency=0))
    paths.append(_pil_png(tmp_path, "g16.png", Image.fromarray(
        rng.integers(0, 65536, hw, dtype=np.uint16))))
    paths.append(_pil_png(tmp_path, "la.png", Image.fromarray(rgb[:, :, :2].copy(), "LA")))
    paths.append(_pil_png(tmp_path, "g1.png", Image.fromarray(rgb[:, :, 0] > 100)))
    for bits in (2, 4):  # PIL writes sub-byte grey only as mode "1"
        path = str(tmp_path / f"g{bits}.png")
        with open(path, "wb") as f:
            f.write(hand_png(rgb[:, :, :1] >> (8 - bits), 0, bits))
        paths.append(path)
    for channels in (3, 4):
        path = str(tmp_path / f"c16_{channels}.png")
        assert cv2.imwrite(path, rng.integers(0, 65536, hw + (channels,), dtype=np.uint16))
        paths.append(path)
    depths = {}
    for path in paths:
        with open(path, "rb") as f:
            head = f.read(26)
        depths[os.path.basename(path)] = (head[24], head[25])  # bit depth, colour type
        _same_as_cv2(path)
    assert depths["p1.png"] == (1, 3) and depths["p2.png"] == (2, 3) and depths["p4.png"] == (4, 3)
    assert depths["g16.png"] == (16, 0) and depths["la.png"] == (8, 4)
    assert depths["g1.png"] == (1, 0) and depths["g2.png"] == (2, 0) and depths["g4.png"] == (4, 0)
    assert depths["c16_3.png"] == (16, 2) and depths["c16_4.png"] == (16, 6)


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "grey8", "rgb16", "grey_alpha8"])
@pytest.mark.parametrize("hw", [(1, 1), (3, 2), (9, 17), (16, 8)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_hand_written_adam7_png(tmp_path, kind, hw):
    ctype, channels, depth = {"rgb8": (2, 3, 8), "rgba8": (6, 4, 8), "grey8": (0, 1, 8),
                              "rgb16": (2, 3, 16), "grey_alpha8": (4, 2, 8)}[kind]
    rng = np.random.default_rng(sum(hw) + channels)
    px = rng.integers(0, 2 ** depth, hw + (channels,))
    path = str(tmp_path / "a7.png")
    with open(path, "wb") as f:
        f.write(adam7_png(px, ctype, depth))
    _same_as_cv2(path)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("hw", [(1, 1), (5, 3), (31, 45)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_pil_bmps(tmp_path, mode, hw):
    """PIL's 1-bit, 8-bit (grey and palette), 24-bit and 32-bit BMPs."""
    rgb = smooth_image(*hw, seed=len(mode))[:, :, ::-1]
    im = Image.fromarray(rgb).quantize(50) if mode == "P" else Image.fromarray(rgb).convert(mode)
    path = str(tmp_path / "b.bmp")
    im.save(path)
    _same_as_cv2(path)


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
def test_hand_written_bmps(tmp_path, top_down):
    """4-bit palette, and 16-bit 5-5-5 (plain) and 5-6-5 (BI_BITFIELDS)."""
    h, w = 7, 11
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 16, (h, w)).astype(np.uint8)
    pal = b"".join(bytes([i * 16, 255 - i * 16, i * 8, 0]) for i in range(16))
    packed = [bytes((int(r[i]) << 4) | (int(r[i + 1]) if i + 1 < w else 0)
                    for i in range(0, w, 2)) for r in idx]
    v = rng.integers(0, 65536, (h, w)).astype("<u2")
    files = {"b4.bmp": bmp(packed, w, h, 4, palette=pal, top_down=top_down),
             "b555.bmp": bmp([r.tobytes() for r in v & 0x7FFF], w, h, 16, top_down=top_down),
             "b565.bmp": bmp([r.tobytes() for r in v], w, h, 16,
                             masks=(0xF800, 0x07E0, 0x001F), top_down=top_down)}
    for name, data in files.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        _same_as_cv2(path)


def test_tiff_webp_and_rle_bmp_raise(tmp_path):
    """TIFF and WebP, which the port once refused, decode to cv2's pixels;
    RLE BMP decodes too (tests/test_torch_bmp_rle_cmyk.py), and what still
    raises is an RLE stream cv2 gives None for: here uncompressed rows
    relabelled RLE, whose first code is a run past its row (the JAX
    package's PIL branch then raises on the palette image)."""
    img = smooth_image(16, 16, 9)[:, :, ::-1]
    for ext in (".tif", ".webp"):
        path = str(tmp_path / f"a{ext}")
        Image.fromarray(img).save(path)
        _same_as_cv2(path)
    for comp, name in ((1, "RLE8"), (2, "RLE4")):
        path = str(tmp_path / f"{name}.bmp")
        data = bytearray(bmp([bytes([200, 1, 2, 3])] * 4, 4, 4, 8 if comp == 1 else 4,
                             palette=bytes(16 * 4)))
        data[30:34] = comp.to_bytes(4, "little")  # biCompression
        with open(path, "wb") as f:
            f.write(bytes(data))
        assert cv2.imread(path) is None
        with pytest.raises(ValueError, match=f"{name} BMP run past the end of its row"):
            imread(path)
        assert image_size(path) == (4, 4)


def test_committed_fixtures_equal_cv2_and_their_hashes():
    """The files ``chip_smoke.py`` [35] and [36] decode on the card: the
    port's pixels are the JAX package's (cv2's, or its PIL branch's where
    cv2 gives None), and those are the ones hashed in ``hashes.json``; the
    files listed as refused raise."""
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        manifest = json.load(f)
    names = sorted(n for n in os.listdir(FIXTURES) if n != "hashes.json")
    assert names == sorted([*manifest["images"], *manifest["refused"]])
    total = 0
    for name in names:
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        if name in manifest["refused"]:
            assert jax_read(path) is None
            with pytest.raises(ValueError, match=name):
                imread(path)
            continue
        want = manifest["images"][name]
        img = imread(path)
        assert np.array_equal(img, jax_read(path)), name
        assert list(img.shape) == want["shape"]
        assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"], name
    assert total < 200 * 1024


def _png_with_exif(path, img, orientation, after_idat):
    from torch_image_fixtures import exif_after_idat

    buf = io.BytesIO()
    ex = Image.Exif()
    ex[274] = orientation
    Image.fromarray(np.ascontiguousarray(img[:, :, ::-1])).save(buf, format="PNG",
                                                                exif=ex.tobytes())
    data = buf.getvalue()
    with open(path, "wb") as f:
        f.write(exif_after_idat(data) if after_idat else data)


@pytest.mark.parametrize("after_idat", [False, True], ids=["before_idat", "after_idat"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_as_cv2_and_check_image(tmp_path, orientation, after_idat):
    """A PNG's ``eXIf`` chunk, before or after the image data: the pixels
    cv2 returns (oriented), and the shape the JAX package's ``check_image``
    records (swapped under 6 and 8 by PIL's ``_getexif``; 5 and 7 stay as
    stored, the JAX package's quirk), with and without the full check."""
    from yolov6_tpu.data.datasets import check_image as jax_check_image
    from yolov6_tpu_torch.data.datasets import check_image

    path = str(tmp_path / "e.png")
    _png_with_exif(path, smooth_image(11, 19, orientation), orientation, after_idat)
    got = imread(path)
    want = cv2.imread(path)
    assert got.shape == want.shape == ((19, 11, 3) if orientation >= 5 else (11, 19, 3))
    assert np.array_equal(got, want)
    for full in (False, True):
        shape, msg = check_image(path, full_check=full)
        shape_j, msg_j = jax_check_image(path, full_check=full)
        assert shape == tuple(shape_j) == ((11, 19) if orientation in (6, 8) else (19, 11))
        assert msg == msg_j == ""


def test_mpo_reads_its_first_image(tmp_path):
    """An MPO (PIL's ``save_all``: an APP2 MPF segment listing two images):
    cv2's pixels of the first image, PIL's format name ``mpo`` (which keeps
    ``check_image``'s JPEG restore away), and a plain JPEG stays ``jpeg``."""
    from yolov6_tpu.data.datasets import check_image as jax_check_image
    from yolov6_tpu_torch.data.datasets import check_image
    from yolov6_tpu_torch.data.image_io import image_format, mpo_images

    a, b = smooth_image(30, 41, 1), smooth_image(30, 41, 2)
    path = str(tmp_path / "two.mpo")
    Image.fromarray(a[:, :, ::-1].copy()).save(path, format="MPO", save_all=True,
                                               append_images=[Image.fromarray(b)])
    with open(path, "rb") as f:
        data = f.read()
    assert mpo_images(data) == 2 and data.count(b"\xff\xd8\xff") >= 2
    _same_as_cv2(path)
    assert image_format(path) == "mpo"
    with Image.open(path) as im:
        assert im.format == "MPO"
    for full in (False, True):
        assert check_image(path, full) == (tuple(jax_check_image(path, full)[0]), "")
    jpg = str(tmp_path / "one.jpg")
    Image.fromarray(a).save(jpg, format="MPO")  # a single image: PIL writes plain JPEG
    assert image_format(jpg) == "jpeg"
