"""The port's training augmentations (yolov6_tpu_torch/data/data_augment.py,
data/native_aug.py and its C++ library data/csrc/train_aug.cc) against cv2
and the JAX package, on the CPU.

Tolerances: none, but against cv2's warpAffine.
- The 8-bit HSV conversions equal cv2's over every input: all 2^24 colours
  RGB/BGR -> HSV, and every HSV triple (H < 180) -> RGB/BGR, at widths that
  take cv2's SIMD loop, its scalar tail, and both.
- The HSV jitter, the affine matrix, the label geometry, mixup and the mosaic
  placement equal the JAX functions given the same draws (the JAX package
  draws from ``random``/``np.random`` seeded as the port's ``Draws``).
- The C++ warp, blend and letterbox equal the numpy oracles and the JAX
  package's native library bit for bit; the warp is within
  tests/test_native_aug.py's tolerance of cv2.warpAffine over the
  materialised mosaic (99th percentile of |diff| <= 1, max <= 4).
"""

import random

import cv2
import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu import native
from yolov6_tpu.data import data_augment as jaug
from yolov6_tpu.data import native_aug as jnative_aug

from yolov6_tpu_torch.data import data_augment as aug
from yolov6_tpu_torch.data import native_aug

CHUNK = 1 << 20  # pixels a conversion call, to bound memory


def _all_colours():
    c = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8)


def _all_hsv():
    c = np.arange(180 << 16, dtype=np.uint32)
    return np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8)


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_to_hsv_equals_cv2_on_every_colour(order):
    code = cv2.COLOR_RGB2HSV if order == "rgb" else cv2.COLOR_BGR2HSV
    px = _all_colours()
    for lo in range(0, len(px), CHUNK):
        block = px[lo:lo + CHUNK].reshape(-1, 1024, 3)
        rgb = block if order == "rgb" else block[..., ::-1]
        np.testing.assert_array_equal(aug.rgb_to_hsv(rgb), cv2.cvtColor(block, code))


# 1024: cv2's SIMD loop only; 33: one scalar pixel a row; 7: scalar only
@pytest.mark.parametrize("width", [1024, 33, 7])
@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_from_hsv_equals_cv2_on_every_hsv_triple(order, width):
    code = cv2.COLOR_HSV2RGB if order == "rgb" else cv2.COLOR_HSV2BGR
    px = _all_hsv()
    px = px[: len(px) // width * width]
    step = CHUNK // width * width
    for lo in range(0, len(px), step):
        block = px[lo:lo + step].reshape(-1, width, 3)
        got = aug.hsv_to_rgb(block)
        np.testing.assert_array_equal(got if order == "rgb" else got[..., ::-1],
                                      cv2.cvtColor(block, code))


GAINS = [(1.0, 1.0, 1.0), (1.012, 1.55, 0.71), (0.987, 0.4, 1.33), (1.5, 1.7, 0.6)]


@pytest.mark.parametrize("gains", GAINS, ids=str)
def test_augment_hsv_rgb_equals_jax(gains):
    rng = np.random.default_rng(3)
    im = rng.integers(0, 256, (48, 80, 3), np.uint8)  # 80: SIMD and scalar pixels a row
    want = im.copy()
    jaug.augment_hsv_rgb(want, gains)
    got = im.copy()
    aug.augment_hsv_rgb(got, gains)
    np.testing.assert_array_equal(got, want)


def test_augment_hsv_bgr_equals_jax_with_the_same_draws():
    rng = np.random.default_rng(4)
    for seed in range(4):
        im = rng.integers(0, 256, (40, 64, 3), np.uint8)
        want, got = im.copy(), im.copy()
        np.random.seed(seed)
        jaug.augment_hsv(want, 0.015, 0.7, 0.4)
        aug.augment_hsv(got, 0.015, 0.7, 0.4, rng=aug.Draws(seed))
        np.testing.assert_array_equal(got, want)


def test_draws_follow_the_jax_packages_generators():
    hyp = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, flipud=0.5, fliplr=0.5)
    for seed in (0, 7, 123456789):
        random.seed(seed)
        np.random.seed(seed)
        want = (jnative_aug.draw_flips(hyp), jnative_aug.draw_hsv_gains(hyp))
        rng = aug.Draws(seed)
        assert (native_aug.draw_flips(hyp, rng), native_aug.draw_hsv_gains(hyp, rng)) == want
    assert native_aug.draw_hsv_gains(dict(hsv_h=0, hsv_s=0, hsv_v=0), aug.Draws(0)) is None
    assert aug.sample_seed(1, 2, 3) == aug.sample_seed(1, 2, 3) != aug.sample_seed(1, 3, 2)


@pytest.mark.parametrize("angle,scale,center", [(0.0, 1.0, (0, 0)), (7.3, 0.6, (0, 0)),
                                                (-31.0, 1.4, (12.5, -3.0))])
def test_rotation_matrix_equals_cv2(angle, scale, center):
    np.testing.assert_array_equal(aug.rotation_matrix_2d(angle, center, scale),
                                  cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("degrees,shear", [(0.0, 0.0), (10.0, 2.0), (45.0, 10.0)])
def test_transform_matrix_equals_jax(degrees, shear):
    for seed in range(5):
        random.seed(seed)
        want = jaug.get_transform_matrix((96, 128), (64, 80), degrees, 0.5, shear, 0.1)
        got = aug.get_transform_matrix((96, 128), (64, 80), degrees, 0.5, shear, 0.1,
                                       aug.Draws(seed))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def _labels(rng, n, w, h):
    xy = rng.uniform(0, 1, (n, 2)) * [w, h]
    wh = rng.uniform(2, 40, (n, 2))
    return np.concatenate([rng.integers(0, 4, (n, 1)), xy, xy + wh], 1)


def test_label_geometry_equals_jax():
    rng = np.random.default_rng(5)
    for seed in range(5):
        random.seed(seed)
        M, s = jaug.get_transform_matrix((128, 128), (64, 64), 10.0, 0.5, 2.0, 0.1)
        lb = _labels(rng, 12, 128, 128)
        np.testing.assert_array_equal(aug.affine_labels(lb.copy(), M, s, 64, 64),
                                      jaug.affine_labels(lb.copy(), M, s, 64, 64))
        b1, b2 = rng.uniform(0, 50, (4, 9)), rng.uniform(0, 50, (4, 9))
        np.testing.assert_array_equal(aug.box_candidates(b1, b2), jaug.box_candidates(b1, b2))
    assert len(aug.affine_labels(np.zeros((0, 5)), M, s, 64, 64)) == 0
    for i in range(4):
        for xc, yc in ((10, 90), (64, 64), (120, 3)):
            assert (aug.mosaic_placement(i, xc, yc, 50, 70, 64, 64)
                    == jaug.mosaic_placement(i, xc, yc, 50, 70, 64, 64))
    lb = np.concatenate([rng.integers(0, 4, (6, 1)), rng.uniform(0.1, 0.9, (6, 4))], 1)
    np.testing.assert_array_equal(aug.mosaic_labels_shift(lb, 50, 70, 13, -4),
                                  jaug.mosaic_labels_shift(lb, 50, 70, 13, -4))


def test_mixup_equals_jax_with_the_same_draws():
    rng = np.random.default_rng(6)
    a, b = rng.integers(0, 256, (2, 32, 48, 3), np.uint8)
    la, lb = rng.uniform(size=(3, 5)), rng.uniform(size=(2, 5))
    np.random.seed(11)
    want = jaug.mixup(a, la, b, lb)
    got = aug.mixup(a, la, b, lb, aug.Draws(11))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _mosaic_inputs(rng, th, tw):
    imgs = [rng.integers(0, 256, (int(rng.integers(th // 2, th + 1)),
                                  int(rng.integers(tw // 2, tw + 1)), 3), np.uint8)
            for _ in range(4)]
    yc, xc = int(rng.integers(th // 2, 3 * th // 2)), int(rng.integers(tw // 2, 3 * tw // 2))
    place = np.array([aug.mosaic_placement(i, xc, yc, im.shape[1], im.shape[0], th, tw)[:6]
                      for i, im in enumerate(imgs)], np.int32)
    return imgs, place


@pytest.mark.parametrize("shape", [(96, 96), (64, 160)], ids=str)
def test_warp_equals_oracle_and_jax_library(shape):
    th, tw = shape
    rng = np.random.default_rng(th + tw)
    for trial in range(12):
        imgs, place = _mosaic_inputs(rng, th, tw)
        M, _ = aug.get_transform_matrix((th * 2, tw * 2), (th, tw), 10.0, 0.5, 2.0, 0.1,
                                        aug.Draws(trial))
        minv = np.linalg.inv(M)[:2].reshape(6)
        flip_lr, flip_ud = trial % 2 == 1, trial % 4 >= 2
        got = native_aug.train_aug(imgs, place, minv, shape, flip_lr, flip_ud)
        np.testing.assert_array_equal(
            got, native_aug.train_aug_plain(imgs, place, minv, shape, flip_lr, flip_ud))
        np.testing.assert_array_equal(got, native.train_aug_native(
            imgs, place, minv, shape, flip_lr=flip_lr, flip_ud=flip_ud))


def test_warp_within_tolerance_of_cv2():
    """The fused pass against cv2.warpAffine over the materialised mosaic
    canvas (the JAX package's cv2 path)."""
    rng = np.random.default_rng(0)
    th = tw = 96
    for trial in range(5):
        imgs, place = _mosaic_inputs(rng, th, tw)
        M, _ = aug.get_transform_matrix((th * 2, tw * 2), (th, tw), 10.0, 0.5, 2.0, 0.1,
                                        aug.Draws(trial))
        canvas = np.full((th * 2, tw * 2, 3), 114, np.uint8)
        for im, (x1a, y1a, x2a, y2a, x1b, y1b) in zip(imgs, place):
            canvas[y1a:y2a, x1a:x2a] = im[y1b:y1b + y2a - y1a, x1b:x1b + x2a - x1a]
        want = cv2.warpAffine(canvas, M[:2], dsize=(tw, th), borderValue=(114, 114, 114))
        got = native_aug.train_aug(imgs, place, np.linalg.inv(M)[:2].reshape(6), (th, tw))
        diff = np.abs(got.astype(int) - want)
        assert np.percentile(diff, 99) <= 1 and diff.max() <= 4, (trial, diff.max())


def test_identity_warp_and_flips_are_exact():
    im = np.random.default_rng(1).integers(0, 256, (64, 80, 3), np.uint8)
    place = np.array([[0, 0, 80, 64, 0, 0]], np.int32)
    ident = np.array([1.0, 0, 0, 0, 1.0, 0])
    for flip_lr in (False, True):
        for flip_ud in (False, True):
            want = im[::-1 if flip_ud else 1, ::-1 if flip_lr else 1]
            np.testing.assert_array_equal(
                native_aug.train_aug([im], place, ident, (64, 80), flip_lr, flip_ud), want)


def test_blend_equals_oracle_and_jax_library():
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, 256, (2, 33, 47, 3), np.uint8)
    for r in (0.437, 0.5, 0.61234, float(np.random.RandomState(3).beta(32, 32))):
        want = native.blend_native(a.copy(), b, r)
        np.testing.assert_array_equal(native_aug.blend(a.copy(), b, r), want)
        np.testing.assert_array_equal(native_aug.blend_plain(a, b, r), want)


def test_letterbox_equals_jax_library():
    rng = np.random.default_rng(3)
    for _ in range(40):
        im = rng.integers(0, 256, (int(rng.integers(8, 200)), int(rng.integers(8, 200)), 3),
                          np.uint8)
        shape = (int(rng.integers(8, 200)), int(rng.integers(8, 200)))
        for scaleup in (True, False):
            got = native_aug.letterbox(im, shape, scaleup=scaleup)
            want = native.letterbox_native(im, shape, scaleup=scaleup)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]


def test_native_pass_rejects_bad_input():
    im = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="1 to 8"):
        native_aug.train_aug([im] * 9, np.zeros((9, 6)), np.eye(3)[:2], (8, 8))
    with pytest.raises(ValueError, match="reads outside"):
        native_aug.train_aug([im], np.array([[0, 0, 9, 8, 0, 0]]), np.eye(3)[:2], (8, 8))
    with pytest.raises(ValueError, match="uint8"):
        native_aug.train_aug([im.astype(np.float32)], np.array([[0, 0, 8, 8, 0, 0]]),
                             np.eye(3)[:2], (8, 8))
    with pytest.raises(ValueError, match="one shape"):
        native_aug.blend(im, np.zeros((8, 9, 3), np.uint8), 0.5)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises; nothing falls back to the numpy version."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native_aug._build(str(tmp_path / "lib.so"))
    monkeypatch.setattr(native_aug, "_lib", None)
    monkeypatch.setattr(native_aug, "lib_path", lambda: str(tmp_path / "never_built.so"))
    with pytest.raises(RuntimeError, match="failed"):
        native_aug.load()
