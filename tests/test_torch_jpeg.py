"""The port's JPEG decoder (yolov6_tpu_torch/data/jpeg.py, csrc/jpeg_decode.cc)
through ``image_io.imread`` and ``image_io.image_size``, against ``cv2.imread``
and the JAX package's ``check_image`` (PIL), which the JAX loaders read
images with. The pixels must be equal exactly (``np.array_equal``): the
decoder follows libjpeg-turbo's integer pipeline, which cv2 carries.

The files are written here by cv2 from seeded numpy images (noise under a
blur, so that the quantiser keeps both smooth areas and detail), or are the
repository's demo JPEGs."""

import hashlib
import os
import struct
import threading

import cv2
import numpy as np
import pytest
from PIL import Image

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.data.datasets import check_image

from yolov6_tpu_torch.data import jpeg
from yolov6_tpu_torch.data.image_io import image_size, imread

from torch_port_utils import REPO_ROOT

import chip_smoke

SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return cv2.addWeighted(cv2.GaussianBlur(noise, (0, 0), 3), 0.8, noise, 0.2, 0)


def _check(path):
    """imread equals cv2.imread and image_size equals check_image's shape."""
    want = cv2.imread(path)
    assert want is not None
    got = imread(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    assert np.array_equal(got, want), (got.shape, want.shape)
    assert image_size(path) == check_image(path)[0]


@pytest.mark.parametrize("name", sorted(chip_smoke.DEMO_JPEGS))
def test_demo_images_equal_cv2_and_the_card_constants(name):
    """The demo JPEGs (baseline, 4:2:0) decode as cv2 decodes them, and
    cv2.imread gives the sha256 that chip_smoke.py checks on the card."""
    path = os.path.join(REPO_ROOT, name)
    _check(path)
    shape, digest = chip_smoke.DEMO_JPEGS[name]
    want = cv2.imread(path)
    assert want.shape == shape
    assert hashlib.sha256(want.tobytes()).hexdigest() == digest


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_quality_and_sampling(tmp_path, quality, sampling):
    path = str(tmp_path / "q.jpg")
    assert cv2.imwrite(path, _image(61, 97, seed=quality), [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]])
    _check(path)


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (9, 17), (61, 97), (479, 641)],
                         ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("sampling", ["444", "420", "422", "440"])
def test_odd_sizes(tmp_path, hw, sampling):
    """Widths and heights that are not multiples of the MCU: the edges of the
    fancy upsampling, and the plain replication below 3 chroma columns."""
    path = str(tmp_path / "odd.jpg")
    assert cv2.imwrite(path, _image(*hw, seed=hw[0]), [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]])
    _check(path)


@pytest.mark.parametrize("hw", [(1, 1), (17, 9), (97, 61)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_grayscale(tmp_path, hw):
    path = str(tmp_path / "grey.jpg")
    assert cv2.imwrite(path, _image(*hw)[:, :, 0], [cv2.IMWRITE_JPEG_QUALITY, 85])
    _check(path)


@pytest.mark.parametrize("interval", [1, 3, 7])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_restart_intervals(tmp_path, interval, sampling):
    path = str(tmp_path / "rst.jpg")
    assert cv2.imwrite(path, _image(67, 131, seed=interval), [
        cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]])
    with open(path, "rb") as f:
        assert b"\xff\xdd" in f.read()  # a DRI segment
    _check(path)


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_optimised_huffman_tables(tmp_path, sampling):
    path = str(tmp_path / "opt.jpg")
    assert cv2.imwrite(path, _image(80, 120, seed=5), [
        cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]])
    _check(path)


def _exif_app1(orientation, little_endian):
    """An APP1 Exif segment whose IFD0 holds the orientation tag only."""
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("little_endian", [True, False], ids=["II", "MM"])
def test_exif_orientation(tmp_path, orientation, little_endian):
    """cv2.imread applies orientations 1-8; check_image swaps w and h for 6
    and 8 only, and image_size keeps that quirk (for 5 and 7 the recorded
    shape is not the decoded one)."""
    ok, buf = cv2.imencode(".jpg", _image(37, 53, seed=orientation))
    data = buf.tobytes()
    path = str(tmp_path / "exif.jpg")
    with open(path, "wb") as f:
        f.write(data[:2] + _exif_app1(orientation, little_endian) + data[2:])
    _check(path)
    assert jpeg.jpeg_size(data[:2] + _exif_app1(orientation, little_endian) + data[2:]) == (
        53, 37, orientation)
    h, w = imread(path).shape[:2]
    assert image_size(path) == ((w, h) if orientation not in (5, 7) else (h, w))


def _patch_sof(data, marker=None, precision=None):
    """``data`` with its SOF marker code or sample precision replaced."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def test_unsupported_and_corrupt_files_raise_value_error(tmp_path):
    """What stays unread raises; a progressive file, a CMYK file and files
    whose scan ends early (cut short, no EOI, the scan's tail overwritten by fill
    bytes) decode as cv2 decodes them, grey past the end; a progressive file
    cut before its last scans, RGB or CMYK, decodes block-smoothed as cv2
    decodes it (once refused)."""
    img = _image(40, 48, seed=9)
    ok, buf = cv2.imencode(".jpg", img)
    base = buf.tobytes()
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    cmyk_prog = tmp_path / "cmyk_prog.jpg"
    Image.fromarray(img).convert("CMYK").save(cmyk_prog, "JPEG", progressive=True)
    cases = {
        "twelve_bit": (_patch_sof(base, precision=12), "12-bit JPEG"),
        "arithmetic": (_patch_sof(base, marker=0xC9), "arithmetic-coded JPEG"),
        "lossless": (_patch_sof(base, marker=0xC3), "lossless JPEG"),
        "header_only": (base[:base.index(b"\xff\xda")], "truncated JPEG file"),
    }
    for name, (data, kind) in cases.items():
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=rf"{name}\.jpg: .*({kind})"):
            imread(str(path))
    for name in ("twelve_bit", "arithmetic", "lossless", "header_only"):
        with pytest.raises(ValueError, match=rf"{name}\.jpg: "):
            image_size(str(tmp_path / f"{name}.jpg"))
    decoded = {  # CMYK, once refused, too
        "cmyk": cmyk.read_bytes(),
        "progressive": prog.tobytes(),
        "truncated": base[:len(base) // 2],
        "no_eoi": base[:-2],
        "bad_huffman_code": base[:-40] + b"\xff" * 38 + base[-2:],
        "progressive_cut": prog.tobytes()[:len(prog) // 2],
        "cmyk_progressive_cut": cmyk_prog.read_bytes()[:len(cmyk_prog.read_bytes()) // 2],
    }
    for name, data in decoded.items():
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        _check(str(path))


def test_decodes_from_threads_at_once():
    """Concurrent decodes (ctypes releases the GIL) give cv2's pixels."""
    paths = [os.path.join(REPO_ROOT, name) for name in sorted(chip_smoke.DEMO_JPEGS)]
    want = [cv2.imread(p) for p in paths]
    errors = []

    def work(k):
        try:
            for i in range(6):
                j = (i + k) % len(paths)
                if not np.array_equal(imread(paths[j]), want[j]):
                    errors.append((k, j))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises; nothing falls back to another decoder."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setattr(jpeg, "library_path", lambda source: str(tmp_path / "never_built.so"))
    with pytest.raises(RuntimeError, match="failed"):
        jpeg.load()
    with pytest.raises(RuntimeError, match="failed"):
        imread(os.path.join(REPO_ROOT, "data", "images", "image1.jpg"))
