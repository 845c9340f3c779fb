"""The port's ``check_image`` (yolov6_tpu_torch/data/datasets.py) against the
JAX package's (PIL, with its cv2 fallback) on one set of files: good PNG,
JPEG and BMP, an image too small, a PNG with a corrupt IDAT, a file of
garbage, a truncated JPEG, and JPEGs with Exif orientation 6 and 8. Both
give the same shape (or None) and the same kind of message, with and
without the full check; under the full check each side restores its own
copy of the truncated JPEG, and cv2 decodes the two restored files to
equal pixels (tolerance: none; both are quality-100 4:4:4 libjpeg-turbo
files of the same image). Then the scans: a dataset with an unreadable
file scans without ``check_images`` (the file kept at shape (0, 0)) and
drops it with ``check_images``, as JAX's does."""

import os
import shutil
import struct

import cv2
import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.data.datasets import TrainValDataset as JaxDataset
from yolov6_tpu.data.datasets import check_image as jax_check_image

from yolov6_tpu_torch.data.datasets import TrainValDataset, check_image
from yolov6_tpu_torch.data.image_io import imwrite_png

from torch_image_fixtures import smooth_image


def _exif(orientation):
    """An APP1 Exif segment whose IFD0 holds the orientation tag only."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def _files(root):
    """name -> path of the set, written under ``root``."""
    os.makedirs(root, exist_ok=True)
    paths = {}

    def put(name, data):
        paths[name] = os.path.join(root, name)
        with open(paths[name], "wb") as f:
            f.write(data)

    img = smooth_image(40, 56, 1)
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    put("good.jpg", jpg)
    put("good.png", cv2.imencode(".png", img)[1].tobytes())
    put("good.bmp", cv2.imencode(".bmp", img)[1].tobytes())
    put("small.png", cv2.imencode(".png", img[:8, :30])[1].tobytes())
    png = bytearray(cv2.imencode(".png", img)[1].tobytes())
    i = png.index(b"IDAT") + 20
    png[i] ^= 0xFF  # the chunk's CRC no longer holds
    put("corrupt.png", bytes(png))
    put("garbage.jpg", np.random.default_rng(2).integers(0, 256, 500, np.uint8).tobytes())
    put("truncated.jpg", cv2.imencode(".jpg", smooth_image(48, 64, 3))[1].tobytes()[:1200])
    put("truncated_small.jpg", cv2.imencode(".jpg", smooth_image(8, 64, 4))[1].tobytes()[:-40])
    for o in (6, 8):
        put(f"exif{o}.jpg", jpg[:2] + _exif(o) + jpg[2:])
    return paths


def _kind(msg):
    if not msg:
        return ""
    if "restored" in msg:
        return "restored"
    assert "ignoring corrupt image" in msg, msg
    return "ignored"


@pytest.mark.parametrize("full_check", [False, True], ids=["header", "full_check"])
def test_check_image_equals_jax(tmp_path, full_check):
    ours, theirs = _files(str(tmp_path / "ours")), _files(str(tmp_path / "theirs"))
    got = {}
    for name in ours:
        shape, msg = check_image(ours[name], full_check=full_check)
        shape_j, msg_j = jax_check_image(theirs[name], full_check=full_check)
        assert (None if shape is None else tuple(shape)) == (
            None if shape_j is None else tuple(shape_j)), name
        assert _kind(msg) == _kind(msg_j), (name, msg, msg_j)
        got[name] = (shape, _kind(msg))
    assert got["garbage.jpg"] == (None, "ignored")
    assert got["exif6.jpg"][0] == got["exif8.jpg"][0] == (40, 56)
    assert got["small.png"] == ((30, 8), "")  # the size check falls back to a decode
    if full_check:
        assert got["corrupt.png"] == (None, "ignored")
        assert got["truncated.jpg"] == ((64, 48), "restored")
        assert got["truncated_small.jpg"][1] == ""  # below 10 px: never restored
        restored, restored_j = (cv2.imread(p["truncated.jpg"]) for p in (ours, theirs))
        np.testing.assert_array_equal(restored, restored_j)
        for p in (ours, theirs):
            with open(p["truncated.jpg"], "rb") as f:
                assert f.read()[-2:] == b"\xff\xd9"
    else:
        assert got["corrupt.png"] == ((56, 40), "")
        assert got["truncated.jpg"] == ((64, 48), "")


@pytest.mark.parametrize("mode", ["RGB", "CMYK"])
def test_truncated_progressive_restore_equals_jax(tmp_path, mode):
    """A progressive JPEG cut before its last scans (one libjpeg
    block-smooths), RGB and CMYK: each side restores its own copy under the
    full check, and cv2 decodes the two restored files to equal pixels
    (tolerance: none), as for the baseline file above."""
    from PIL import Image

    src = tmp_path / "src.jpg"
    Image.fromarray(smooth_image(48, 64, 6)).convert(mode).save(src, "JPEG", progressive=True)
    data = src.read_bytes()
    paths = []
    for side in ("ours", "theirs"):
        os.makedirs(tmp_path / side)
        paths.append(str(tmp_path / side / "cut.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(data[:len(data) // 2])
    shape, msg = check_image(paths[0], full_check=True)
    shape_j, msg_j = jax_check_image(paths[1], full_check=True)
    assert tuple(shape) == tuple(shape_j) == (64, 48)
    assert _kind(msg) == _kind(msg_j) == "restored"
    restored, restored_j = (cv2.imread(p) for p in paths)
    np.testing.assert_array_equal(restored, restored_j)


def _dataset(root, names):
    """A YOLO set of ``names`` from ``_files``, each with one label row; a
    label file of ``bad_labels.png`` out of range."""
    files = _files(os.path.join(root, "src"))
    for kind in ("images", "labels"):
        os.makedirs(os.path.join(root, kind, "train"), exist_ok=True)
    for name in names:
        shutil.copy(files[name], os.path.join(root, "images", "train", name))
        stem = os.path.splitext(name)[0]
        with open(os.path.join(root, "labels", "train", f"{stem}.txt"), "w") as f:
            f.write("0 0.5 0.5 0.2 0.3\n")
    imwrite_png(os.path.join(root, "images", "train", "bad_labels.png"), smooth_image(30, 40, 5))
    with open(os.path.join(root, "labels", "train", "bad_labels.txt"), "w") as f:
        f.write("1 0.5 0.5 0.2 0.3\n2 1.5 0.5 0.2 0.3\n")
    return os.path.join(root, "images", "train")


@pytest.mark.parametrize("checks", [(False, False), (True, True)], ids=["no_checks", "checks"])
def test_scan_keeps_and_drops_as_jax(tmp_path, checks):
    """Without checks the unreadable files are kept at (0, 0); with
    ``check_images`` they are dropped and the truncated JPEG restored; with
    ``check_labels`` the out-of-range label file gives its image no labels."""
    names = ["good.jpg", "good.png", "corrupt.png", "garbage.jpg", "truncated.jpg", "exif6.jpg"]
    check_images, check_labels = checks
    sets = {}
    for side, cls in (("ours", TrainValDataset), ("theirs", JaxDataset)):
        img_dir = _dataset(str(tmp_path / side), names)
        sets[side] = cls(img_dir, img_size=64, batch_size=2, augment=False,
                         check_images=check_images, check_labels=check_labels)
    ours, theirs = sets["ours"], sets["theirs"]
    base = lambda ds: [os.path.basename(p) for p in ds.img_paths]  # noqa: E731
    assert base(ours) == base(theirs)
    np.testing.assert_array_equal(ours.shapes, theirs.shapes)
    for a, b in zip(ours.labels, theirs.labels):
        np.testing.assert_array_equal(a, b)
    kept = dict(zip(base(ours), ours.shapes.tolist()))
    if check_images:
        assert "garbage.jpg" not in kept and "corrupt.png" not in kept
        assert kept["truncated.jpg"] == [64, 48]
    else:
        assert kept["garbage.jpg"] == [0, 0]
        assert kept["corrupt.png"] == [56, 40]  # the header reads; the pixels do not
    labels = dict(zip(base(ours), ours.labels))
    assert len(labels["bad_labels.png"]) == (0 if check_labels else 2)


def test_label_cache_records_the_checks(tmp_path):
    """A scan without checks is not read back as a checked one: the
    unreadable file is dropped once ``check_images`` asks for it."""
    img_dir = _dataset(str(tmp_path), ["good.png", "garbage.jpg"])
    first = TrainValDataset(img_dir, img_size=64, augment=False)
    assert len(first) == 3
    checked = TrainValDataset(img_dir, img_size=64, augment=False, check_images=True)
    assert sorted(os.path.basename(p) for p in checked.img_paths) == ["bad_labels.png",
                                                                     "good.png"]
    with pytest.raises(FileNotFoundError, match="unreadable image"):
        first._resolve_shapes()
