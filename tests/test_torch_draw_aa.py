"""The port's shapes (yolov6_tpu_torch/utils/draw.py over
utils/csrc/drawing.cc) against cv2 5.0.0 at LINE_AA, as the JAX package draws
its boxes, label backgrounds and synthetic shapes: ``cv2.rectangle`` (thick
outline and filled), ``cv2.circle`` (filled and thick) and ``cv2.fillPoly``,
over seeded boxes, radii and polygons that also run off the image, each
image compared with ``np.array_equal``; ``rectangle`` at LINE_8; and the
synthetic dataset, whose pixels are the JAX generator's."""

import glob
import hashlib
import json
import tempfile

import cv2
import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import yolov6_tpu.data.synth_detect as jax_synth

from yolov6_tpu_torch.data.image_io import imread
from yolov6_tpu_torch.data.synth_detect import generate_split
from yolov6_tpu_torch.utils import draw, text


def _cases(seed, n=60):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = int(rng.integers(12, 160)), int(rng.integers(12, 160))
        canvas = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 1.5)
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        yield rng, canvas, color


def _pt(rng, canvas, margin=20):
    h, w = canvas.shape[:2]
    return int(rng.integers(-margin, w + margin)), int(rng.integers(-margin, h + margin))


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3, 4, 5, 6, 7, 10, 19])
def test_rectangle_aa(thickness):
    for rng, canvas, color in _cases(thickness + 50):
        p1, p2 = _pt(rng, canvas), _pt(rng, canvas)
        want, got = canvas.copy(), canvas.copy()
        cv2.rectangle(want, p1, p2, color, thickness, cv2.LINE_AA)
        draw.rectangle(got, p1, p2, color, thickness, text.LINE_AA)
        assert np.array_equal(got, want), (p1, p2, thickness)


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3])
def test_rectangle_line8(thickness):
    for rng, canvas, color in _cases(thickness + 80, 30):
        p1, p2 = _pt(rng, canvas), _pt(rng, canvas)
        want, got = canvas.copy(), canvas.copy()
        cv2.rectangle(want, p1, p2, color, thickness)
        draw.rectangle(got, p1, p2, color, thickness)
        assert np.array_equal(got, want), (p1, p2, thickness)


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3, 5, 8, 13])
def test_circle_aa(thickness):
    """Radii from 0 to 70 (each step of ellipse2Poly's delta: 90, 30, 18
    and 5 degrees), centres inside and outside."""
    for rng, canvas, color in _cases(thickness + 110):
        c, r = _pt(rng, canvas), int(rng.integers(0, 71))
        want, got = canvas.copy(), canvas.copy()
        cv2.circle(want, c, r, color, thickness, cv2.LINE_AA)
        draw.circle(got, c, r, color, thickness)
        assert np.array_equal(got, want), (c, r, thickness)


@pytest.mark.parametrize("kind", ["triangle", "polygon", "two_contours"])
def test_fill_poly_aa(kind):
    """The synthetic set's upright triangles, random polygons (convex or
    not, self-intersecting), and two contours in one call."""
    for rng, canvas, color in _cases(len(kind)):
        if kind == "triangle":
            cx, cy = _pt(rng, canvas, 0)
            r = int(rng.integers(1, 60))
            pts = [np.array([[cx, cy - r], [cx - r, cy + r], [cx + r, cy + r]])]
        else:
            pts = [np.array([_pt(rng, canvas) for _ in range(int(rng.integers(3, 8)))])
                   for _ in range(1 if kind == "polygon" else 2)]
        want, got = canvas.copy(), canvas.copy()
        cv2.fillPoly(want, [p.astype(np.int32) for p in pts], color, cv2.LINE_AA)
        draw.fill_poly(got, pts, color)
        assert np.array_equal(got, want), pts


def test_checks_and_failed_build(tmp_path, monkeypatch):
    img = np.zeros((10, 10, 3), np.uint8)
    with pytest.raises(ValueError, match="HxWx3"):
        draw.circle(img[:, :, :1], (5, 5), 3, 255, -1)
    with pytest.raises(ValueError, match="line type"):
        draw.rectangle(img, (0, 0), (5, 5), 255, 1, 4)
    with pytest.raises(ValueError, match="negative"):
        draw.circle(img, (5, 5), -1, 255, -1)
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(draw, "_lib", None)
    monkeypatch.setattr(draw, "library_path", lambda source: str(tmp_path / "never_built.so"))
    with pytest.raises(RuntimeError, match="failed"):
        draw.circle(img, (5, 5), 3, 255, -1)


@pytest.mark.parametrize("size", [96, 160])
def test_synth_images_are_jax_generators(size, tmp_path, monkeypatch):
    """The port's generator writes, for the same seed, the pixels the JAX
    generator hands cv2.imwrite (before its JPEG encode) and the same label
    rows."""
    written = []
    monkeypatch.setattr(jax_synth.cv2, "imwrite",
                        lambda path, img, *a: written.append(img.copy()) or True)
    jax_synth.generate_split(str(tmp_path / "ji"), str(tmp_path / "jl"), 10, size, 4,
                             np.random.default_rng(size), "x")
    generate_split(str(tmp_path / "pi"), str(tmp_path / "pl"), 10, size, 4,
                   np.random.default_rng(size), "x")
    ours = [imread(p) for p in sorted(glob.glob(str(tmp_path / "pi" / "*.png")))]
    assert len(ours) == len(written) == 10
    for got, want in zip(ours, written):
        assert np.array_equal(got, want)
    for a, b in zip(sorted(glob.glob(str(tmp_path / "jl" / "*"))),
                    sorted(glob.glob(str(tmp_path / "pl" / "*")))):
        assert open(a).read() == open(b).read()


def test_committed_hashes_are_cv2s_and_the_ports():
    """tests/data/torch_draw/hashes.json, which chip_smoke.py [38] holds the
    port to on the card's host: each case drawn by cv2 and the JAX package
    (tests/torch_draw_fixtures.py) and by the port (chip_smoke.draw_case)
    has the committed hash, and so do the synthetic images of both
    generators."""
    import chip_smoke
    import torch_draw_fixtures as fixtures

    with open(fixtures.OUT) as f:
        committed = json.load(f)
    assert committed["opencv"] == cv2.__version__
    assert [c["name"] for c in committed["cases"]] == [c["name"] for c in fixtures.CASES]
    for case in committed["cases"]:
        assert fixtures.digest(fixtures.draw_case_cv2(case)) == case["sha256"], case["name"]
        assert fixtures.digest(chip_smoke.draw_case(case)) == case["sha256"], case["name"]
    synth = committed["synth"]
    with tempfile.TemporaryDirectory() as tmp:
        want = [fixtures.digest(img) for img in fixtures.synth_cv2(tmp)]
        generate_split(tmp + "/pi", tmp + "/pl", synth["n"], synth["img_size"], synth["nc"],
                       np.random.default_rng(synth["seed"]), "train")
        got = [hashlib.sha256(imread(p).tobytes()).hexdigest()
               for p in sorted(glob.glob(tmp + "/pi/*.png"))]
    assert want == got == synth["sha256"]
