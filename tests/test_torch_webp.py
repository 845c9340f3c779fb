"""The port's WebP reader and writer (yolov6_tpu_torch/data/webp.py,
data/csrc/webp_decode.cc) against what the JAX package does with a WebP:
``cv2.imread`` (libwebp's ``WebPDecodeBGRInto``: the VP8 decoder, the
fancy upsampler and its YUV->BGR; VP8L), ``check_image``'s PIL shape, Exif
swap, message and format, and ``cv2.imwrite('.webp')``'s lossless files
read back.

Tolerance: none. Every decode is bit-equal to cv2's pixels; the port's
own lossless files read back through ``cv2.imread`` to the image exactly
(their bytes are not libwebp's: a deliberate departure, ROADMAP queue 3).
The files are the committed fixtures of ``tests/data/torch_images/`` and
cv2- and PIL-written files at odd sizes and qualities here.
"""

import ctypes
import glob
import io
import os
import struct

import cv2
import numpy as np
import PIL
import pytest
from PIL import Image

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.data.datasets import check_image as jax_check_image

from yolov6_tpu_torch.data.datasets import check_image
from yolov6_tpu_torch.data.image_io import image_format, image_size, imread, imwrite
from yolov6_tpu_torch.data.webp import chunks, decode_webp, encode_webp

from torch_image_fixtures import FIXTURES, smooth_image

WEBP_FIXTURES = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".webp"))


def _same_as_cv2(path):
    want = cv2.imread(path)
    assert want is not None, path
    got = imread(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    assert got.shape == want.shape and np.array_equal(got, want), path
    return got


@pytest.mark.parametrize("name", WEBP_FIXTURES)
def test_fixture_decodes_as_cv2_and_checks_as_jax(name):
    path = os.path.join(FIXTURES, name)
    _same_as_cv2(path)
    for full in (False, True):
        shape, msg = check_image(path, full_check=full)
        shape_j, msg_j = jax_check_image(path, full_check=full)
        assert shape == tuple(shape_j) and msg == msg_j == "", (name, full)
    assert image_format(path) == "webp"
    with Image.open(path) as im:
        assert im.format == "WEBP"


def _lossy(img, quality, **kw):
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[:, :, ::-1])).save(buf, format="WEBP",
                                                                quality=quality, **kw)
    return buf.getvalue()


SIZES = [(1, 1), (2, 3), (9, 7), (16, 16), (17, 33), (61, 97), (120, 161)]


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_lossy_at_odd_sizes_and_qualities(tmp_path, hw):
    """VP8 at qualities 1-100 (segments, the simple and normal filters at
    every sharpness libwebp picks, skipped macroblocks), smooth and noisy
    content; the fancy upsampler's odd widths and heights."""
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    smooth = smooth_image(*hw, seed=hw[0] + hw[1])
    noise = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    for k, (img, q, kw) in enumerate([(smooth, 1, {}), (smooth, 50, {}), (smooth, 100, {}),
                                      (noise, 30, {}), (noise, 90, dict(method=0)),
                                      (smooth, 75, dict(method=6)),
                                      (noise, 5, dict(method=2))]):
        path = str(tmp_path / f"q{k}.webp")
        with open(path, "wb") as f:
            f.write(_lossy(img, q, **kw))
        _same_as_cv2(path)
    path = str(tmp_path / "cv2.webp")
    assert cv2.imwrite(path, smooth, [cv2.IMWRITE_WEBP_QUALITY, 80])
    _same_as_cv2(path)


class _Config(ctypes.Structure):  # libwebp's WebPConfig (encode.h, ABI 0x020f)
    _fields_ = ([("lossless", ctypes.c_int), ("quality", ctypes.c_float)]
                + [(n, ctypes.c_int) for n in ("method", "image_hint", "target_size")]
                + [("target_PSNR", ctypes.c_float)]
                + [(n, ctypes.c_int) for n in (
                    "segments", "sns_strength", "filter_strength", "filter_sharpness",
                    "filter_type", "autofilter", "alpha_compression", "alpha_filtering",
                    "alpha_quality", "pass_", "show_compressed", "preprocessing", "partitions",
                    "partition_limit", "emulate_jpeg_size", "thread_level", "low_memory",
                    "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin",
                    "qmax")] + [("pad", ctypes.c_uint32 * 8)])


_P = ctypes.c_void_p


class _Picture(ctypes.Structure):  # WebPPicture
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int), ("y", _P), ("u", _P),
                ("v", _P), ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int), ("a", _P),
                ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2), ("argb", _P),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3), ("writer", _P),
                ("custom_ptr", _P), ("extra_info_type", ctypes.c_int), ("extra_info", _P),
                ("stats", _P), ("error_code", ctypes.c_int), ("progress_hook", _P),
                ("user_data", _P), ("pad3", ctypes.c_uint32 * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", ctypes.c_uint32 * 8), ("memory_", _P), ("memory_argb_", _P),
                ("pad7", _P * 2)]


class _Writer(ctypes.Structure):  # WebPMemoryWriter
    _fields_ = [("mem", _P), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32)]


def _libwebp():
    """The libwebp that PIL ships, for its encoder's settings PIL does not
    pass on (the filter type, sharpness, partitions, segments)."""
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    sharp = glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))
    webp = glob.glob(os.path.join(libs, "libwebp-*.so*"))
    if not webp:
        pytest.skip("PIL ships no libwebp here")
    for lib in sharp:
        ctypes.CDLL(lib, mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(webp[0])


def _libwebp_encode(img, quality, **settings):
    lib = _libwebp()
    abi = 0x020F
    cfg = _Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), abi)
    for k, v in settings.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg))
    pic = _Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), abi)
    pic.width, pic.height = img.shape[1], img.shape[0]
    img = np.ascontiguousarray(img)
    assert lib.WebPPictureImportBGR(ctypes.byref(pic), img.ctypes.data_as(_P), img.shape[1] * 3)
    out = _Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(out))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, _P).value
    pic.custom_ptr = ctypes.addressof(out)
    assert lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)), pic.error_code
    data = ctypes.string_at(out.mem, out.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(out))
    return data


def _vp8_header(data):
    """(segments used, simple filter, filter level, sharpness, partitions)
    read from a simple VP8 file's first partition (RFC 6386 9.2-9.5)."""
    pos = data.index(b"VP8 ") + 8
    d = data[pos + 10:]
    state = dict(value=(d[0] << 8) | d[1], rng=255, count=0, pos=2)

    def bit(prob=128):
        split = 1 + (((state["rng"] - 1) * prob) >> 8)
        if state["value"] >= split << 8:
            state["rng"] -= split
            state["value"] -= split << 8
            b = 1
        else:
            state["rng"] = split
            b = 0
        while state["rng"] < 128:
            state["value"] <<= 1
            state["rng"] <<= 1
            state["count"] += 1
            if state["count"] == 8:
                state["count"] = 0
                state["value"] |= d[state["pos"]] if state["pos"] < len(d) else 0
                state["pos"] += 1
        return b

    def get(n):
        v = 0
        for _ in range(n):
            v = (v << 1) | bit()
        return v

    get(2)  # colour space, clamping
    segments = get(1)
    if segments:
        update_map = get(1)
        if get(1):
            get(1)
            for n in (7, 7, 7, 7, 6, 6, 6, 6):
                if get(1):
                    get(n + 1)
        if update_map:
            for _ in range(3):
                if get(1):
                    get(8)
    simple, level, sharpness = get(1), get(6), get(3)
    if get(1) and get(1):
        for _ in range(8):
            if get(1):
                get(7)
    return segments, simple, level, sharpness, 1 << get(2)


LIBWEBP_SETTINGS = [  # libwebp honours ``partitions`` at method 0 only
    dict(filter_type=0, filter_strength=60, filter_sharpness=0),
    dict(filter_type=0, filter_strength=100, filter_sharpness=7, autofilter=0),
    dict(filter_type=0, filter_strength=30, filter_sharpness=3, partitions=3, method=0),
    dict(filter_type=1, filter_strength=90, filter_sharpness=5, partitions=2, method=0),
    dict(filter_type=1, filter_strength=20, filter_sharpness=2, segments=1, sns_strength=0),
    dict(filter_type=1, filter_strength=0),
    dict(segments=4, sns_strength=100, partitions=1, method=0),
]


@pytest.mark.parametrize("settings", LIBWEBP_SETTINGS, ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("quality", [10, 75])
def test_lossy_filters_partitions_and_segments(tmp_path, settings, quality):
    """libwebp's encoder at the settings cwebp exposes (``-nostrong``: the
    simple loop filter; ``-sharpness``, ``-f``, ``-partition_limit``,
    ``-segments``), checked in the frame header, decoded as cv2 decodes."""
    img = np.concatenate([smooth_image(40, 72, 3),
                          np.random.default_rng(4).integers(0, 256, (24, 72, 3), np.uint8)])
    data = _libwebp_encode(img, quality, **settings)
    segments, simple, level, sharpness, parts = _vp8_header(data)
    if settings.get("filter_strength"):
        assert simple == (settings.get("filter_type") == 0) and level > 0
        assert sharpness == settings["filter_sharpness"]
    if "partitions" in settings:
        assert parts == 1 << settings["partitions"]
    path = str(tmp_path / "lib.webp")
    with open(path, "wb") as f:
        f.write(data)
    _same_as_cv2(path)


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_lossless_transforms(tmp_path, hw):
    """VP8L with the predictor, cross-colour and subtract-green transforms
    (photographic content), the colour cache and LZ77 (repeats), colour
    indexing with 1, 2, 4 and 8 pixels a byte (2, 4, 16, 200 colours),
    alpha dropped without premultiplying."""
    rgb = np.ascontiguousarray(smooth_image(*hw, seed=hw[1])[:, :, ::-1])
    tile = np.tile(rgb[:3, :3], (hw[0] // 3 + 1, hw[1] // 3 + 1, 1))[:hw[0], :hw[1]]
    images = {"photo": rgb, "tiled": np.ascontiguousarray(tile)}
    for n in (2, 4, 16, 200):
        images[f"pal{n}"] = np.asarray(Image.fromarray(rgb).quantize(n).convert("RGB"))
    for name, im in images.items():
        for method in (0, 4, 6):
            path = str(tmp_path / f"{name}_{method}.webp")
            Image.fromarray(im).save(path, lossless=True, method=method, quality=100)
            got = _same_as_cv2(path)
            np.testing.assert_array_equal(got, im[:, :, ::-1])
    rgba = np.dstack([rgb, np.arange(rgb[:, :, 0].size).reshape(hw).astype(np.uint8)])
    path = str(tmp_path / "rgba.webp")
    Image.fromarray(rgba, "RGBA").save(path, lossless=True, exact=True)
    np.testing.assert_array_equal(_same_as_cv2(path), rgb[:, :, ::-1])


def _exif(o):
    ex = Image.Exif()
    ex[274] = o
    return ex.tobytes()


def test_exif_orientations_and_check_image(tmp_path):
    """All eight orientations: cv2's pixels; PIL's size swapped under 6 and
    8 (``_getexif``), as ``check_image`` records it, while 5 and 7 keep the
    stored shape there (the JAX package's quirk)."""
    img = smooth_image(13, 21, 3)
    for o in range(1, 9):
        for lossless in (False, True):
            path = str(tmp_path / f"o{o}_{lossless}.webp")
            Image.fromarray(img[:, :, ::-1].copy()).save(path, lossless=lossless, quality=90,
                                                        exif=_exif(o))
            got = _same_as_cv2(path)
            assert got.shape[:2] == ((21, 13) if o >= 5 else (13, 21))
            shape_j = jax_check_image(path)[0]
            assert image_size(path) == tuple(shape_j) == ((13, 21) if o in (6, 8) else (21, 13))


def test_animations_give_the_first_frame_on_the_canvas(tmp_path):
    """PIL's animations (lossy and lossless frames), and the committed one
    whose first frame is smaller than the canvas and offset: black around
    it, as libwebp's anim decoder leaves a zeroed canvas."""
    img = smooth_image(19, 26, 6)[:, :, ::-1]
    frames = [Image.fromarray(np.ascontiguousarray(img)),
              Image.fromarray(np.ascontiguousarray(img[::-1]))]
    for lossless in (False, True):
        path = str(tmp_path / f"anim_{lossless}.webp")
        frames[0].save(path, save_all=True, append_images=frames[1:], lossless=lossless,
                       duration=50, quality=80)
        kinds = [k for k, _ in chunks(open(path, "rb").read())]
        assert kinds.count(b"ANMF") == 2
        _same_as_cv2(path)
    path = os.path.join(FIXTURES, "webp_anim_offset.webp")
    got = _same_as_cv2(path)
    assert (got[:6] == 0).all() and (got[:, :4] == 0).all() and got[6:16, 4:16].any()


def test_alph_chunk_filters_and_compression_do_not_change_the_colour(tmp_path):
    """Lossy with alpha at several alpha qualities and methods (compressed
    and filtered ``ALPH``): the colour cv2 returns is that of the ``VP8``
    chunk alone, which the port decodes, alpha dropped."""
    rgb = smooth_image(24, 40, 9)[:, :, ::-1]
    alpha = np.linspace(0, 255, 24 * 40).reshape(24, 40).astype(np.uint8)
    rgba = Image.fromarray(np.dstack([rgb, alpha]), "RGBA")
    for k, kw in enumerate([dict(alpha_quality=100), dict(alpha_quality=10),
                            dict(alpha_quality=100, method=6), dict(alpha_quality=50)]):
        path = str(tmp_path / f"a{k}.webp")
        rgba.save(path, quality=70, **kw)
        parts = dict(chunks(open(path, "rb").read()))
        assert b"ALPH" in parts and b"VP8X" in parts
        got = _same_as_cv2(path)
        vp8 = b"VP8 " + struct.pack("<I", len(parts[b"VP8 "])) + parts[b"VP8 "]
        bare = str(tmp_path / f"bare{k}.webp")
        with open(bare, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 4 + len(vp8)) + b"WEBP" + vp8
                    + b"\x00" * (len(vp8) & 1))
        np.testing.assert_array_equal(cv2.imread(bare), got)


@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (5, 1), (13, 27), (64, 64), (101, 37, 4),
                                   (20, 30), (240, 320)], ids=str)
def test_encode_webp_reads_back_exactly(tmp_path, shape):
    """The port's lossless files: cv2 reads them back to the image (grey
    replicated, alpha dropped); so does the port."""
    rng = np.random.default_rng(sum(shape))
    if len(shape) == 3:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
    elif shape[0] * shape[1] > 1000:
        img = smooth_image(*shape, seed=4)
    else:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
    for im in (img, np.full(img.shape, 7, np.uint8)):
        data = encode_webp(im)
        path = str(tmp_path / "enc.webp")
        with open(path, "wb") as f:
            f.write(data)
        want = im[:, :, :3] if im.ndim == 3 else np.repeat(im[:, :, None], 3, axis=2)
        np.testing.assert_array_equal(cv2.imread(path), want)
        np.testing.assert_array_equal(decode_webp(data), want)
        assert image_size(path) == (im.shape[1], im.shape[0])


def test_imwrite_webp_is_lossless(tmp_path):
    img = smooth_image(33, 45, 2)
    path = str(tmp_path / "out.webp")
    imwrite(path, img)
    np.testing.assert_array_equal(cv2.imread(path), img)
    np.testing.assert_array_equal(imread(path), img)
    assert image_format(path) == "webp"
    cv2_path = str(tmp_path / "cv2.webp")
    assert cv2.imwrite(cv2_path, img)  # cv2's default is lossless too: the same pixels
    np.testing.assert_array_equal(cv2.imread(cv2_path), img)
    assert [k for k, _ in chunks(open(cv2_path, "rb").read())] == [b"VP8L"]


def test_refusals_name_the_file(tmp_path):
    img = smooth_image(16, 16, 1)
    data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes()
    cases = {
        "cut.webp": (data[:len(data) // 2], "truncated WebP chunk"),
        "riff.webp": (b"RIFF" + struct.pack("<I", 4) + b"AVI ", "RIFF \\(not WebP\\)"),
        "empty.webp": (b"RIFF" + struct.pack("<I", 4) + b"WEBP", "without chunks"),
        "inter.webp": (data[:20] + bytes([data[20] | 1]) + data[21:], "not a key frame"),
    }
    for name, (bad, kind) in cases.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(bad)
        assert cv2.imread(path) is None, name
        with pytest.raises(ValueError, match=rf"{name}: .*{kind}"):
            imread(path)
