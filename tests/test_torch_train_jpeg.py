"""The train path's JPEG read in the port (yolov6_tpu_torch/data/jpeg.py
``read_jpeg_train``, ``decode_jpeg_scaled``, ``bilinear_resize``; data/
datasets.py ``load_image_rgb``) against the JAX package's native train path
(``TrainValDataset._load_image_rgb`` with ``native.decode_jpeg_resize_native``:
the system libjpeg-turbo's DCT-scaled decode and its float bilinear),
against cv2 (``IMREAD_REDUCED_COLOR_<n>``, the same scaled decode in cv2's
libjpeg-turbo) and against ``cv2.imread`` for block-smoothed files, on the
committed set ``tests/data/torch_jpeg_train/`` (``torch_jpeg_train_fixtures.py``)
and on files written here.

Tolerance: none, with one stated exception. A progressive file cut before
its last scans is block-smoothed from the DC values of the blocks up to two
rows above and below, and the two libjpeg-turbo releases pick those rows
differently for a component sampled twice vertically (4:2:0's and 4:4:0's
luma): cv2's 3.1.2, which the port follows, may read an MCU's padding row
two below, and sees no row two above in a small image's partial last iMCU
row; the system's 2.1.5 (the JAX library) clamps at iMCU rows instead, also
in iMCU row 1. So against the JAX library such a file may differ by a level
or so near those rows (on the demo image by at most 1, in the last two iMCU
rows: the test below shows it); against cv2 it is equal. The committed cut
files are 4:2:2 and 4:4:4, where the releases agree, so that whole train
samples over the set hold without a tolerance.

The Exif-6 file is the deliberate departure: the JAX library decodes the
stored pixels into the scan's swapped size (stretched, unrotated, under
labels of the rotated frame); the port orients first, as cv2 does, then
resizes with the same bilinear. The test shows both."""

import hashlib
import io
import json
import os
import random
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu import native
from yolov6_tpu.data.datasets import TrainValDataset as JaxDataset

from yolov6_tpu_torch.data import jpeg
from yolov6_tpu_torch.data.data_augment import sample_seed
from yolov6_tpu_torch.data.datasets import TrainValDataset
from yolov6_tpu_torch.data.image_io import imread

from torch_port_utils import REPO_ROOT
from torch_jpeg_train_fixtures import (
    EXIF6, FIXTURES, REDUCED, SAMPLING, bilinear, cv2_jpeg, picture,
)

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
NAMES = sorted(MANIFEST["files"])
IMG, SEED = MANIFEST["img_size"], 4
SPECIFIC_H, SPECIFIC_W = MANIFEST["specific_shape"]
TARGETS = {"img_size": {}, "specific": dict(specific_shape=True, height=SPECIFIC_H,
                                            width=SPECIFIC_W)}


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def jpeg_set(tmp_path_factory):
    """The committed set copied into ``images/train`` with two label rows an
    image (``labels/train``); returns the image directory."""
    root = tmp_path_factory.mktemp("jpeg_set")
    rng = np.random.default_rng(3)
    for kind in ("images", "labels"):
        os.makedirs(root / kind / "train")
    for name in NAMES:
        shutil.copy(os.path.join(FIXTURES, name), root / "images" / "train" / name)
        rows = [(int(rng.integers(0, 4)), *rng.uniform(0.25, 0.75, 2), *rng.uniform(0.1, 0.4, 2))
                for _ in range(2)]
        with open(root / "labels" / "train" / (os.path.splitext(name)[0] + ".txt"), "w") as f:
            f.writelines(" ".join(f"{v:.6f}" if i else str(v) for i, v in enumerate(r)) + "\n"
                         for r in rows)
    return str(root / "images" / "train")


def _pair(img_dir, hyp, **kw):
    ours = TrainValDataset(img_dir, img_size=IMG, batch_size=4, augment=True, hyp=hyp,
                           task="train", seed=SEED, **kw)
    theirs = JaxDataset(img_dir, img_size=IMG, batch_size=4, augment=True, hyp=hyp,
                        task="train", **kw)
    assert theirs._native_aug
    assert ours.img_paths == theirs.img_paths
    return ours, theirs


@pytest.mark.parametrize("target", list(TARGETS))
def test_train_read_equals_jax_native_read(jpeg_set, target):
    """Every file but the Exif-6 one: the port's read is the JAX read, bit
    for bit (denominators 1-8, every subsampling, grey, progressive, restart
    intervals, odd sizes, the cut progressive files; the CMYK file and the
    PNG named .jpg through both packages' cv2-style fallback); and each equals
    the manifest's hash, which chip_smoke.py [39] holds the card's build to."""
    ours, theirs = _pair(jpeg_set, dict(mosaic=1.0), **TARGETS[target])
    k = list(TARGETS).index(target)
    denoms = set()
    for index, path in enumerate(ours.img_paths):
        name = os.path.basename(path)
        read = MANIFEST["files"][name]["reads"][k]
        img, hw0, hw = ours.load_image_rgb(index)
        img_j, hw0_j, hw_j = theirs._load_image_rgb(index)
        assert img.dtype == np.uint8 and img.flags.c_contiguous
        assert list(hw) == read["dst"] and tuple(hw0) == tuple(hw0_j) and hw == hw_j, name
        assert _sha(img) == read["sha256"], name
        assert jpeg.train_denom(*hw0, max(SPECIFIC_H, SPECIFIC_W) if k else IMG) == read["denom"]
        denoms.add(read["denom"])
        if name != EXIF6:
            np.testing.assert_array_equal(img, img_j, err_msg=name)
    assert denoms == ({1, 2, 4, 8} if k == 0 else {1, 2, 4})


@pytest.mark.parametrize("target", list(TARGETS))
def test_exif6_read_departs_from_jax_as_recorded(jpeg_set, target):
    """JAX's native read of the Exif-6 file is the stored (unrotated)
    pixels squeezed into the rotated frame's size; the port's is cv2's
    oriented decode at the same DCT scale resized by the same bilinear
    (here its numpy twin). Both have the rotated frame's size; they differ."""
    ours, theirs = _pair(jpeg_set, dict(mosaic=1.0), **TARGETS[target])
    index = [os.path.basename(p) for p in ours.img_paths].index(EXIF6)
    path = ours.img_paths[index]
    img, (h0, w0), (h, w) = ours.load_image_rgb(index)
    img_j, _, hw_j = theirs._load_image_rgb(index)
    assert (h0, w0) == (200, 150) and (h, w) == hw_j and h > w  # rotated frame
    denom = MANIFEST["files"][EXIF6]["reads"][list(TARGETS).index(target)]["denom"]
    rotated = cv2.imread(path, REDUCED[denom])[:, :, ::-1]
    stored = cv2.imread(path, REDUCED[denom] | cv2.IMREAD_IGNORE_ORIENTATION)[:, :, ::-1]
    assert rotated.shape[0] > rotated.shape[1] and stored.shape[0] < stored.shape[1]
    np.testing.assert_array_equal(img, bilinear(rotated, h, w))  # the port: rotated
    np.testing.assert_array_equal(img_j, bilinear(stored, h, w))  # JAX: stretched
    assert not np.array_equal(img, img_j)


@pytest.mark.parametrize("name", NAMES)
def test_imread_equals_cv2_on_the_set(name):
    """``imread`` (full scale, BGR, oriented) is ``cv2.imread``'s image and
    the manifest's hash; the cut progressive files are block-smoothed (cut
    before the last of a cv2 or PIL progression's ten scans)."""
    path = os.path.join(FIXTURES, name)
    got = imread(path)
    np.testing.assert_array_equal(got, cv2.imread(path))
    assert _sha(got) == MANIFEST["files"][name]["imread_sha256"]
    if "_cut_prog_" in name:
        with open(path, "rb") as f:
            assert f.read().count(b"\xff\xda") < 10


def _write(tmp_path, data, name="x.jpg"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("hw", [(667, 1001), (37, 61), (9, 17)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("sampling", list(SAMPLING) + ["grey"])
@pytest.mark.parametrize("kind", ["baseline", "progressive", "restart", "progressive_restart"])
def test_scaled_decode_equals_cv2_reduced_and_the_native_library(tmp_path, hw, sampling, kind):
    """``decode_jpeg_scaled`` at 1, 1/2, 1/4 and 1/8 is cv2's
    ``IMREAD_REDUCED_COLOR_<n>`` (as RGB) and the JAX library's decode with
    no resize: jidctred.c's IDCTs, the chroma sizes at scale, fancy
    upsampling but at 1/8, partial MCUs at odd sizes."""
    data = cv2_jpeg(*hw, seed=hw[0] + len(sampling), sampling=sampling if sampling != "grey"
                    else "420", quality=80, progressive="progressive" in kind,
                    rst=2 if "restart" in kind else 0, grey=sampling == "grey")
    path = _write(tmp_path, data)
    for denom in (1, 2, 4, 8):
        got = jpeg.decode_jpeg_scaled(data, denom)
        assert got.shape == (-(-hw[0] // denom), -(-hw[1] // denom), 3)
        np.testing.assert_array_equal(got, cv2.imread(path, REDUCED[denom])[:, :, ::-1])
        np.testing.assert_array_equal(
            got, native.decode_jpeg_resize_native(path, denom, *got.shape[:2]))


def test_bilinear_equals_the_native_library(tmp_path):
    """``bilinear_resize`` (compiled without contraction) gives the JAX
    library's bytes, down and up, through its decode-and-resize entry on a
    near-lossless file; the numpy twin agrees."""
    data = cv2.imencode(".jpg", picture(57, 83, 21), [cv2.IMWRITE_JPEG_QUALITY, 100,
                                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])[1]
    path = _write(tmp_path, data.tobytes())
    src = jpeg.decode_jpeg_scaled(data.tobytes(), 1)
    for dh, dw in [(28, 41), (57, 82), (100, 30), (131, 197), (1, 1), (3, 200)]:
        got = jpeg.bilinear_resize(src, dh, dw)
        np.testing.assert_array_equal(got, native.decode_jpeg_resize_native(path, 1, dh, dw))
        np.testing.assert_array_equal(got, bilinear(src, dh, dw))


def _pil_progressive(img_bgr):
    out = io.BytesIO()
    Image.fromarray(img_bgr[:, :, ::-1]).save(out, "JPEG", quality=90, progressive=True)
    return out.getvalue()


@pytest.mark.parametrize("frac", [0.3, 0.5])
def test_cut_progressive_demo_image_against_both_releases(tmp_path, frac):
    """The demo image1 (640x480) re-encoded progressive by PIL and cut at 30%
    and 50%: ``imread`` is ``cv2.imread``'s block-smoothed image exactly, at
    full scale and at every DCT scale (cv2's reduced reads). Against the
    system libjpeg-turbo 2.1.5 (the JAX library) the port's reads differ,
    by at most 1 level and only in the last two luma iMCU rows (image rows
    448-479 and their scaled rows), where the releases reach different DC
    rows below a block."""
    data = _pil_progressive(cv2.imread(os.path.join(REPO_ROOT, "data/images/image1.jpg")))
    cut = data[:int(len(data) * frac)]
    path = _write(tmp_path, cut)
    np.testing.assert_array_equal(imread(path), cv2.imread(path))
    differs = False
    for denom in (1, 2, 4, 8):
        got = jpeg.decode_jpeg_scaled(cut, denom)
        np.testing.assert_array_equal(got, cv2.imread(path, REDUCED[denom])[:, :, ::-1])
        nat = native.decode_jpeg_resize_native(path, denom, *got.shape[:2])
        diff = np.abs(got.astype(int) - nat.astype(int))
        assert diff.max() <= 1
        rows = np.flatnonzero(diff.any(axis=(1, 2)))
        assert rows.size == 0 or rows.min() >= 448 // denom, rows
        differs |= rows.size > 0
    assert differs  # the releases do differ on this file


@pytest.mark.parametrize("hw", [(20, 121), (9, 37), (41, 30)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("sampling", ["420", "440", "411"])
def test_cut_progressive_small_images_equal_cv2(tmp_path, hw, sampling):
    """Small progressive files (two or three iMCU rows, a partial last one)
    cut at ten points: the block-smoothed decode, full size and at 1/2, 1/4
    and 1/8, is cv2's exactly. The rows two above and below a block in a
    partial last iMCU row are where cv2's libjpeg-turbo counts rows its own
    way (a 121x20 4:4:0 file once showed it)."""
    data = cv2_jpeg(*hw, seed=hw[1], sampling=sampling, quality=50, progressive=True)
    for frac in np.linspace(0.2, 0.9, 10):
        cut = data[:int(len(data) * frac)]
        path = _write(tmp_path, cut)
        want = cv2.imread(path)
        if want is None:
            continue
        np.testing.assert_array_equal(imread(path), want, err_msg=f"cut at {frac:.2f}")
        for denom in (2, 4, 8):
            np.testing.assert_array_equal(jpeg.decode_jpeg_scaled(cut, denom),
                                          cv2.imread(path, REDUCED[denom])[:, :, ::-1],
                                          err_msg=f"cut at {frac:.2f}, 1/{denom}")


def test_train_read_raises_for_12_bit_and_arithmetic_and_falls_back_for_cmyk(tmp_path):
    """The kinds libjpeg-turbo 2.1.5 refuses or decodes but the port does
    not read raise ``ValueError`` naming the kind, never a quiet fallback; a
    CMYK file (libjpeg converts it to no RGB) returns None for the
    caller's imread fallback."""
    base = cv2_jpeg(40, 48, 30, quality=90)
    i = base.index(b"\xff\xc0")
    twelve = bytearray(base)
    twelve[i + 4] = 12
    arith = bytearray(base)
    arith[i + 1] = 0xC9
    for name, data, kind in (("twelve.jpg", twelve, "12-bit JPEG"),
                             ("arith.jpg", arith, "arithmetic-coded JPEG")):
        path = _write(tmp_path, bytes(data), name)
        with pytest.raises(ValueError, match=kind):
            jpeg.read_jpeg_train(path, 2, 20, 24)
        with pytest.raises(ValueError, match=kind):
            jpeg.decode_jpeg_scaled(bytes(data), 1)
    cmyk = os.path.join(FIXTURES, "d2_cmyk_200x140.jpg")
    assert jpeg.read_jpeg_train(cmyk, 2, 44, 64) is None
    with open(cmyk, "rb") as f:
        with pytest.raises(jpeg.NotRGBError, match="CMYK"):
            jpeg.decode_jpeg_scaled(f.read(), 2)


def _hyp(mosaic, mixup=0.0):
    return dict(mosaic=mosaic, mixup=mixup, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=5.0,
                translate=0.1, scale=0.5, shear=1.0, flipud=0.5, fliplr=0.5)


@pytest.fixture(scope="module")
def jpeg_set_less_exif6(jpeg_set, tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_set_less_exif6")
    shutil.copytree(os.path.dirname(os.path.dirname(jpeg_set)), root, dirs_exist_ok=True)
    os.remove(root / "images" / "train" / EXIF6)
    return str(root / "images" / "train")


@pytest.mark.parametrize("mosaic,mixup,target",
                         [(1.0, 0.0, "img_size"), (1.0, 1.0, "img_size"), (0.0, 0.0, "img_size"),
                          (1.0, 0.0, "specific"), (0.0, 0.0, "specific")],
                         ids=["mosaic", "mosaic_mixup", "letterbox", "mosaic_specific",
                              "letterbox_specific"])
def test_train_sample_equals_jax_on_the_jpeg_set(jpeg_set_less_exif6, mosaic, mixup, target):
    """Whole train samples (the mosaic with and without mixup, and the
    letterbox branch, each with the affine, HSV and flips) over the JPEG set
    less its Exif-6 file, under the JAX package's draws seeded as the port's:
    the JAX sample's pixels, labels and shapes."""
    ours, theirs = _pair(jpeg_set_less_exif6, _hyp(mosaic, mixup), **TARGETS[target])
    shape = (SPECIFIC_H, SPECIFIC_W, 3) if target == "specific" else (IMG, IMG, 3)
    for epoch in (0, 1):
        ours.epoch = epoch
        for index in range(len(ours)):
            seed = sample_seed(SEED, epoch, index)
            random.seed(seed)
            np.random.seed(seed)
            img_j, labels_j, path_j, shapes_j = theirs[index]
            img, labels, path, shapes = ours[index]
            assert img.shape == shape and img.dtype == np.uint8
            np.testing.assert_array_equal(img, img_j)
            np.testing.assert_array_equal(labels, labels_j)
            assert path == path_j and shapes == shapes_j
