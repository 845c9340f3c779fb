"""The port's resizers and letterbox (yolov6_tpu_torch/data/data_augment.py)
against cv2.resize and the JAX package's letterbox.

Tolerance: none. ``resize_linear`` and ``resize_area`` must equal
``cv2.resize`` (INTER_LINEAR, INTER_AREA) on uint8 bit for bit, as the JAX
loader calls it: on the fixed cases below (up and down, integer and
non-integer factors, odd and one-pixel sides, the eval sets' resizes at 160
and at 640), on 300 random size pairs between 2 and 240 px a side, and on
the one resize the train loader makes on the learning gate's set (320 ->
160). The letterbox's ratio, pad, shape, border and pixels must equal the
JAX letterbox's.
"""

import cv2
import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.data.data_augment import letterbox as jax_letterbox

from yolov6_tpu_torch.data.data_augment import letterbox, resize_area, resize_linear

from torch_port_utils import (
    CHIP_EVAL_SIZES,
    EVAL_IMG_SIZE,
    EVAL_SIZES,
    loaded_shape,
    rect_batch_shapes,
)

# (src h, w) -> (dst w, h): up and down, integer and non-integer factors, odd
# sizes, one-pixel sides, and the eval set's resizes
RESIZES = [((48, 64), (32, 24)), ((48, 64), (128, 96)), ((37, 53), (71, 29)),
           ((576, 768), (640, 480)), ((240, 320), (640, 480)), ((100, 100), (50, 50)),
           ((99, 101), (33, 40)), ((90, 90), (30, 30)), ((5, 7), (13, 11)), ((1, 17), (5, 3)),
           ((17, 1), (2, 9)), ((61, 97), (160, 100))] + [
    ((h, w), loaded_shape(w, h)[::-1]) for w, h in EVAL_SIZES if max(w, h) != EVAL_IMG_SIZE] + [
    # the chip's eval set at 640 (write_eval_set in chip_smoke.py), and the
    # learning gate's train images, 320 square at 160
    ((h, w), loaded_shape(w, h, img_size=640)[::-1]) for w, h in CHIP_EVAL_SIZES
    if max(w, h) != 640] + [((320, 320), (160, 160))]


def _equal_to_cv2(im, dst):
    for fn, interp in ((resize_linear, cv2.INTER_LINEAR), (resize_area, cv2.INTER_AREA)):
        got, want = fn(im, dst), cv2.resize(im, dst, interpolation=interp)
        assert got.shape == want.shape and got.dtype == np.uint8
        n = int((got != want).sum())
        assert n == 0, (fn.__name__, im.shape, dst, n)


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("src,dst", RESIZES, ids=lambda v: "x".join(map(str, v)))
def test_resizers_within_one_of_cv2(src, dst, channels):
    """Every pixel equal to cv2's (the name is from when 1 was allowed)."""
    rng = np.random.default_rng(src[0] * 1000 + dst[0])
    im = rng.integers(0, 256, src + ((channels,) if channels == 3 else ()), np.uint8)
    _equal_to_cv2(im, dst)


@pytest.mark.parametrize("chunk", range(10))
def test_resizers_equal_cv2_on_random_sizes(chunk):
    """300 random (src, dst) size pairs, 2 to 240 px a side, 30 a case, in 3
    and 1 channels."""
    rng = np.random.default_rng(1000 + chunk)
    for i in range(30):
        src = tuple(int(v) for v in rng.integers(2, 241, 2))
        dst = tuple(int(v) for v in rng.integers(2, 241, 2))
        im = rng.integers(0, 256, src + ((3,) if i % 3 else ()), np.uint8)
        _equal_to_cv2(im, dst)


def _letterbox_cases():
    """Every (loaded image shape, target) the eval-data tests meet: square
    and rect targets, with and without shrink_size, plus scaleup and auto."""
    cases = set()
    for shrink in (0, 6):
        shapes = [loaded_shape(w, h, shrink=shrink) for w, h in EVAL_SIZES]
        targets = [EVAL_IMG_SIZE] + rect_batch_shapes(EVAL_SIZES, 4)
        cases.update((s, t, False, False) for s in shapes for t in targets)
    cases.update(((61, 97), 160, auto, True) for auto in (False, True))
    cases.update(((240, 320), (160, 224), False, scaleup) for scaleup in (False, True))
    return sorted(cases, key=str)


@pytest.mark.parametrize("shape,target,auto,scaleup", _letterbox_cases(), ids=str)
def test_letterbox_matches_jax(shape, target, auto, scaleup):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    im = rng.integers(0, 256, shape + (3,), np.uint8)
    got, r, pad = letterbox(im, target, auto=auto, scaleup=scaleup)
    want, r_j, pad_j = jax_letterbox(im, target, auto=auto, scaleup=scaleup)
    assert r == r_j and pad == pad_j and got.shape == want.shape
    h, w = int(round(shape[0] * r)), int(round(shape[1] * r))
    inner = (slice(pad[1], pad[1] + h), slice(pad[0], pad[0] + w))
    border = np.ones(got.shape[:2], bool)
    border[inner] = False
    assert (got[border] == 114).all() and (want[border] == 114).all()
    np.testing.assert_array_equal(got, want)
