"""The port's JPEG encoder (yolov6_tpu_torch/data/jpeg.py::encode_jpeg,
csrc/jpeg_encode.cc) and ``image_io.imwrite`` against cv2, which the JAX
package writes images with. Tolerance: none. At cv2's defaults (quality 95,
4:2:0) the bytes equal ``cv2.imencode('.jpg', img)``'s; at the other
qualities and at 4:4:4 (quality 100, the restore of ``check_image``) the
bytes equal cv2's with the same parameters, so the decoded pixels are equal
too."""

import os

import cv2
import numpy as np
import pytest

from yolov6_tpu_torch.data.image_io import image_format, imread, imwrite
from yolov6_tpu_torch.data.jpeg import encode_jpeg

from torch_image_fixtures import REPO_ROOT, smooth_image

SIZES = [(1, 1), (2, 3), (8, 8), (9, 17), (16, 16), (17, 23), (61, 97), (64, 96), (479, 641)]


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    return {
        "random": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "smooth": smooth_image(h, w, seed),
        "ramp": np.stack([(x * 7 + y * 3) % 256, (x * 2 + y * 5) % 256, (x + y) % 256],
                         -1).astype(np.uint8),
        "grey": smooth_image(h, w, seed + 1)[:, :, 0],
    }


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_default_bytes_equal_cv2(hw):
    for name, img in _images(*hw, seed=hw[0] + 3 * hw[1]).items():
        want = cv2.imencode(".jpg", img)[1].tobytes()
        assert encode_jpeg(img) == want, name


@pytest.mark.parametrize("quality", [0, 10, 50, 75, 90, 100])
def test_qualities_equal_cv2(quality):
    for name, img in _images(37, 53, seed=quality).items():
        want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
        assert encode_jpeg(img, quality=quality) == want, name


@pytest.mark.parametrize("hw", [(7, 5), (61, 97), (120, 161)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_q100_444_decodes_equal(tmp_path, hw):
    """The restore's setting: the bytes are cv2's at quality 100 and 4:4:4,
    and cv2 decodes the port's file to the pixels of cv2's own."""
    for name, img in _images(*hw, seed=hw[1]).items():
        ours = encode_jpeg(img, quality=100, subsampling="444")
        want = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, 100, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])[1].tobytes()
        assert ours == want, name
        path = str(tmp_path / f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(ours)
        np.testing.assert_array_equal(cv2.imread(path), cv2.imdecode(
            np.frombuffer(want, np.uint8), cv2.IMREAD_COLOR))
        np.testing.assert_array_equal(imread(path), cv2.imread(path))


def test_demo_images_encode_as_cv2():
    for name in ("image1.jpg", "image2.jpg", "image3.jpg"):
        img = cv2.imread(os.path.join(REPO_ROOT, "data", "images", name))
        assert encode_jpeg(img) == cv2.imencode(".jpg", img)[1].tobytes(), name


def test_imwrite_dispatches_on_the_suffix(tmp_path):
    img = smooth_image(19, 29, 4)
    for ext, fmt in ((".jpg", "jpeg"), (".JPEG", "jpeg"), (".png", "png"), (".bmp", "bmp")):
        path = str(tmp_path / f"out{ext}")
        imwrite(path, img)
        assert image_format(path) == fmt
        want = cv2.imread(path)
        np.testing.assert_array_equal(imread(path), want)
        if fmt == "jpeg":
            with open(path, "rb") as f:
                assert f.read() == cv2.imencode(".jpg", img)[1].tobytes()
        else:  # lossless
            np.testing.assert_array_equal(want, img)
    with pytest.raises(ValueError, match="could not find a writer for .gif; the port writes .jpg, "
                                         ".jpeg, .png, .bmp, .tif, .tiff and .webp"):
        imwrite(str(tmp_path / "out.gif"), img)


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="HW grey, HWx3 BGR or HWx4 CMYK"):
        encode_jpeg(np.zeros((4, 4, 2), np.uint8))  # four channels are CMYK samples
    with pytest.raises(ValueError, match="subsampling"):
        encode_jpeg(np.zeros((4, 4, 3), np.uint8), subsampling="422")
    with pytest.raises(ValueError, match="65535"):
        encode_jpeg(np.zeros((1, 70000), np.uint8))
