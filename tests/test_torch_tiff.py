"""The port's TIFF reader and writer (yolov6_tpu_torch/data/tiff.py,
data/csrc/tiff_codec.cc) against what the JAX package does with a TIFF:
``load_image``'s ``cv2.imread`` (libtiff's RGBA interface), then its PIL
branch where cv2 gives None, ``check_image``'s PIL shape, message and
format, and ``cv2.imencode('.tif')``'s bytes.

Tolerance: none. Every decode is bit-equal to the JAX package's pixels,
every recorded shape and format equal, every encoded file byte-equal.
The files are the committed fixtures of ``tests/data/torch_images/``
(``torch_image_fixtures.py``: PIL- and cv2-written TIFFs of every
compression and sample kind, hand-made tiles, planar, big-endian,
BigTIFF and JPEG-in-TIFF files, two DNGs) and PIL-written files at odd
sizes here.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.data.datasets import check_image as jax_check_image

from yolov6_tpu_torch.data import tiff
from yolov6_tpu_torch.data.datasets import check_image
from yolov6_tpu_torch.data.image_io import image_format, image_size, imread, imwrite
from yolov6_tpu_torch.data.tiff import decode_tiff, encode_tiff

from torch_image_fixtures import FIXTURES, hand_tiff, jax_read, smooth_image

TIFF_FIXTURES = sorted(n for n in os.listdir(FIXTURES) if n.endswith((".tif", ".dng")))


def _pil_format(path):
    with Image.open(path) as im:
        return im.format.lower()


@pytest.mark.parametrize("name", TIFF_FIXTURES)
def test_fixture_decodes_as_the_jax_package_reads_it(name):
    """Pixels: ``load_image``'s (cv2, then PIL); shape, message and format:
    ``check_image``'s, with and without the full check."""
    path = os.path.join(FIXTURES, name)
    want = jax_read(path)
    if want is None:
        with pytest.raises(ValueError, match=name):
            imread(path)
    else:
        got = imread(path)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        assert got.shape == want.shape and np.array_equal(got, want), name
    for full in (False, True):
        shape, msg = check_image(path, full_check=full)
        shape_j, msg_j = jax_check_image(path, full_check=full)
        assert shape == (None if shape_j is None else tuple(shape_j)), (name, full)
        assert bool(msg) == bool(msg_j), (msg, msg_j)
    if name != "dng_cfa.dng":
        assert image_format(path) == _pil_format(path) == "tiff"


def test_the_fixtures_cover_every_kind():
    """Each compression, sample kind and layout the reader takes is in a
    fixture: read back from the files' own tags."""
    seen = set()
    for name in TIFF_FIXTURES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        ifd = tiff.parse_ifd0(data)
        seen.add(("compression", ifd.one(259, 1)))
        seen.add(("photometric", ifd.one(262)))
        seen.add(("bits", ifd.one(258, 1)))
        seen.add(("predictor", ifd.one(317, 1)))
        seen.add(("planar", ifd.one(284, 1)))
        seen.add(("tiled", 322 in ifd.tags))
        seen.add(("order", data[:2]))
        seen.add(("big", data[2:4] in (b"+\x00", b"\x00+")))
        seen.add(("extra", ifd.get(338, (None,))[0]))
        seen.add(("dng", tiff.DNG_VERSION in ifd.tags))
    for c in (1, 3, 4, 5, 7, 8, 32946, 32773):
        assert ("compression", c) in seen, c
    for p in (0, 1, 2, 3, 5, 6, 32803):
        assert ("photometric", p) in seen, p
    for kind in [("bits", b) for b in (1, 2, 4, 8, 16)] + [
            ("predictor", 2), ("planar", 2), ("tiled", True), ("order", b"MM"), ("big", True),
            ("extra", 1), ("extra", 2), ("dng", True)]:
        assert kind in seen, kind


def _pil_files(tmp_path, hw):
    rng = np.random.default_rng(hw[0] * 31 + hw[1])
    rgb = np.ascontiguousarray(smooth_image(*hw, seed=hw[1])[:, :, ::-1])
    grey = rgb[:, :, 1]
    files = {}

    def save(name, im, **kw):
        files[name] = str(tmp_path / name)
        im.save(files[name], **kw)

    for comp in (None, "tiff_lzw", "packbits", "tiff_adobe_deflate", "jpeg"):
        save(f"rgb_{comp}.tif", Image.fromarray(rgb), compression=comp)
    for comp in ("group3", "group4", None):
        save(f"bw_{comp}.tif", Image.fromarray(rng.random(hw) > 0.5), compression=comp)
        save(f"bw_smooth_{comp}.tif", Image.fromarray(grey > 128), compression=comp)
    save("grey.tif", Image.fromarray(grey), compression="tiff_lzw")
    save("pal.tif", Image.fromarray(rgb).quantize(100))
    save("rgba.tif", Image.fromarray(np.dstack([rgb, grey]), "RGBA"), compression="tiff_lzw")
    save("cmyk.tif", Image.fromarray(np.dstack([rgb, grey]), "CMYK"), compression="packbits")
    for o in range(1, 9):
        save(f"orient{o}.tif", Image.fromarray(rgb), tiffinfo={274: o})
    for name, arr in (("c16.tif", rng.integers(0, 65536, hw + (3,), dtype=np.uint16)),
                      ("g16.tif", rng.integers(0, 65536, hw, dtype=np.uint16)),
                      ("cv2_rgb.tif", rgb), ("cv2_rgba.tif", np.dstack([rgb, grey]))):
        files[name] = str(tmp_path / name)
        assert cv2.imwrite(files[name], arr)
    return files


@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (37, 53), (64, 40)],
                         ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_pil_and_cv2_tiffs_at_odd_sizes(tmp_path, hw):
    for name, path in _pil_files(tmp_path, hw).items():
        want = jax_read(path)
        assert want is not None, name
        got = imread(path)
        assert got.shape == want.shape and np.array_equal(got, want), name
        w, h = image_size(path)
        with Image.open(path) as im:
            assert (w, h) == im.size, name


def test_orientation_tags_follow_cv2_then_pil(tmp_path):
    """cv2 flips under 1-4 and gives None under 5-8, where PIL reads an
    RGB image oriented at the swapped size; a grey one there raises."""
    rgb = np.ascontiguousarray(smooth_image(11, 17, 3)[:, :, ::-1])
    for o in range(1, 9):
        path = str(tmp_path / f"o{o}.tif")
        Image.fromarray(rgb).save(path, tiffinfo={274: o})
        assert (cv2.imread(path) is None) == (o >= 5)
        np.testing.assert_array_equal(imread(path), jax_read(path))
        assert image_size(path) == ((11, 17) if o >= 5 else (17, 11))
        grey = str(tmp_path / f"g{o}.tif")
        Image.fromarray(rgb[:, :, 0]).save(grey, tiffinfo={274: o})
        if o >= 5:
            with pytest.raises(ValueError, match=rf"orientation {o}, which cv2 does not read"):
                imread(grey)
        else:
            np.testing.assert_array_equal(imread(grey), cv2.imread(grey))


def test_unassociated_alpha_premultiplies_and_16_bit_rounds(tmp_path):
    """cv2's readings: (200, 100, 50, a=128) reads (25, 50, 100) BGR;
    16-bit grey keeps the high byte (0x12FF -> 18), 16-bit RGB rounds."""
    path = str(tmp_path / "ua.tif")
    Image.fromarray(np.full((3, 3, 4), (200, 100, 50, 128), np.uint8), "RGBA").save(path)
    assert imread(path)[0, 0].tolist() == [25, 50, 100] == cv2.imread(path)[0, 0].tolist()
    path = str(tmp_path / "g16.tif")
    assert cv2.imwrite(path, np.array([[0x12FF, 0x0180]], np.uint16))
    assert imread(path)[0, :, 0].tolist() == [18, 1]
    path = str(tmp_path / "c16.tif")
    assert cv2.imwrite(path, np.array([[[0x12FF, 0x0180, 0xFFFF]]], np.uint16))
    assert imread(path)[0, 0].tolist() == cv2.imread(path)[0, 0].tolist() == [19, 1, 255]


def test_refusals_name_the_file_and_the_kind(tmp_path):
    rgb = smooth_image(8, 12, 4)
    flat = rgb.tobytes()
    base = [(258, 3, [8] * 3), (262, 3, [2]), (277, 3, [3])]
    cases = {
        "old_jpeg.tif": (hand_tiff(12, 8, base + [(259, 3, [6])], [flat]),
                         "old-style JPEG TIFF"),
        "jpeg2000.tif": (hand_tiff(12, 8, base + [(259, 3, [34712])], [flat]),
                         "TIFF compression 34712 is not read"),
        "float.tif": (hand_tiff(4, 2, [(258, 3, [32]), (259, 3, [1]), (262, 3, [1]),
                                       (277, 3, [1]), (339, 3, [3])], [bytes(32)]),
                      "32-bit floating-point samples"),
        "int32.tif": (hand_tiff(4, 2, [(258, 3, [32]), (259, 3, [1]), (262, 3, [1]),
                                       (277, 3, [1])], [bytes(32)]),
                      "32-bit samples of sample format 1"),
        "cfa.tif": (hand_tiff(4, 2, [(258, 3, [16]), (259, 3, [1]), (262, 3, [32803]),
                                     (277, 3, [1])], [bytes(16)]), "a DNG CFA image"),
        "lab.tif": (hand_tiff(12, 8, base[:1] + [(259, 3, [1]), (262, 3, [8]), (277, 3, [3])],
                              [flat]), "photometric interpretation 8"),
        "ycbcr.tif": (hand_tiff(12, 8, base[:1] + [(259, 3, [1]), (262, 3, [6]),
                                                   (277, 3, [3])], [flat]),
                      "YCbCr TIFF without JPEG compression"),
        "short.tif": (hand_tiff(12, 8, base + [(259, 3, [8])], [zlib.compress(flat)[:40]]),
                      "Deflate TIFF strip decodes to"),
        "old_lzw.tif": (hand_tiff(12, 8, base + [(259, 3, [5])], [b"\x00\x01\x02\x03"]),
                        "old-style \\(bit-reversed\\) LZW"),
    }
    for name, (data, kind) in cases.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        if name in ("float.tif", "cfa.tif", "old_jpeg.tif"):  # the JAX package raises too
            assert jax_read(path) is None, name
        with pytest.raises(ValueError, match=rf"{name}: .*{kind}"):
            imread(path)
    with pytest.raises(ValueError, match="not a TIFF"):
        decode_tiff(b"II*\x01" + bytes(8))


ENCODE_SIZES = [(1, 1), (1, 7), (2, 2), (5, 3), (37, 53), (64, 64), (1, 5000), (2, 5000),
                (3, 4100), (3, 2185), (4, 1920), (120, 161), (479, 641)]


@pytest.mark.parametrize("hw", ENCODE_SIZES, ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("kind", ["grey", "bgr", "noise", "bgra"])
def test_encode_tiff_is_cv2s_bytes(hw, kind):
    """Smooth and noisy content (the LZW table fills and clears), grey,
    colour and BGRA, one strip to hundreds, and rows wider than a strip's
    8 KiB (the encoder's ratio checkpoint)."""
    if kind == "noise":
        img = np.random.default_rng(hw[0] + hw[1]).integers(0, 256, hw + (3,), dtype=np.uint8)
    else:
        img = smooth_image(*hw, seed=hw[0] * 3 + hw[1], channels=4 if kind == "bgra" else 3)
        if kind == "grey":
            img = img[:, :, 0]
    data = encode_tiff(img)
    assert data == cv2.imencode(".tif", img)[1].tobytes()
    np.testing.assert_array_equal(decode_tiff(data), cv2.imdecode(
        np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


def test_imwrite_tif_and_tiff_write_cv2s_bytes(tmp_path):
    img = smooth_image(21, 34, 8)
    for ext in (".tif", ".tiff", ".TIF"):
        path = str(tmp_path / f"out{ext}")
        imwrite(path, img)
        with open(path, "rb") as f:
            assert f.read() == cv2.imencode(".tif", img)[1].tobytes()
        np.testing.assert_array_equal(imread(path), img)
        assert image_format(path) == "tiff"
    for ext in (".dng", ".mpo"):  # cv2 reads them and writes neither
        with pytest.raises(Exception, match="could not find a writer"):
            cv2.imwrite(str(tmp_path / f"x{ext}"), img)
        with pytest.raises(ValueError, match=rf"could not find a writer for \{ext}"):
            imwrite(str(tmp_path / f"x{ext}"), img)


def test_lzw_strip_of_a_large_image_decodes_fast(tmp_path):
    """640x640 RGB, LZW with the predictor, decodes in well under a second
    (the codec is C++)."""
    import time

    img = smooth_image(640, 640, 12)
    data = cv2.imencode(".tif", img)[1].tobytes()
    decode_tiff(data)
    t0 = time.perf_counter()
    out = decode_tiff(data)
    assert time.perf_counter() - t0 < 1.0
    np.testing.assert_array_equal(out, img)


def test_big_endian_16_bit_predictor_and_bigtiff_tiles(tmp_path):
    """Hand-made: a big-endian 16-bit RGB with the predictor, Deflate; a
    BigTIFF of LZW tiles (the tiles' LZW from the port's encoder, which
    cv2 reads back)."""
    rgb16 = (smooth_image(10, 14, 5).astype(np.uint16) * 257)[:, :, ::-1]
    diff = rgb16.copy()
    diff[:, 1:] -= rgb16[:, :-1]
    data = hand_tiff(14, 10, [(258, 3, [16] * 3), (259, 3, [8]), (262, 3, [2]), (277, 3, [3]),
                              (317, 3, [2])], [zlib.compress(diff.astype(">u2").tobytes())],
                     le=False)
    path = str(tmp_path / "mm16.tif")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(imread(path), cv2.imread(path))
    lib = tiff.load()
    import ctypes

    rgb = np.ascontiguousarray(smooth_image(20, 24, 6)[:, :, ::-1])
    tiles = []
    for ty in (0, 16):
        for tx in (0, 16):
            tile = np.zeros((16, 16, 3), np.uint8)
            part = rgb[ty:ty + 16, tx:tx + 16]
            tile[:part.shape[0], :part.shape[1]] = part
            raw = tile.tobytes()
            out = np.empty(len(raw) * 2, np.uint8)
            got = ctypes.c_size_t()
            assert lib.yolov6_tiff_lzw_encode(raw, len(raw), out.ctypes.data, out.size,
                                              ctypes.byref(got), ctypes.create_string_buffer(64),
                                              64) == 0
            tiles.append(out[:got.value].tobytes())
    data = hand_tiff(24, 20, [(258, 3, [8] * 3), (259, 3, [5]), (262, 3, [2]), (277, 3, [3]),
                              (322, 3, [16]), (323, 3, [16])], tiles, big=True)
    path = str(tmp_path / "big_tiles.tif")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(imread(path), cv2.imread(path))
    np.testing.assert_array_equal(imread(path), rgb[:, :, ::-1])
    assert struct.unpack_from("<H", data, 2)[0] == 43
