"""The port's text (yolov6_tpu_torch/utils/text.py over utils/csrc/truetype.cc)
against cv2 5.0.0, the JAX package's ``cv2.putText`` and ``cv2.getTextSize``:
every image compared with ``np.array_equal``, every size with ``==``.

The grid: every printable ASCII character and the COCO names with scores, in
FONT_HERSHEY_SIMPLEX and FONT_HERSHEY_COMPLEX at thickness 1, 2, 3 and 5, at
the scales ``lw / 3`` for lw 2-20 and 0.5, 0.55, 0.7, 1.0 and 2.5, in random
colours on blurred noise, with origins that clip the text at each border.
The committed font is the one inside the installed cv2 (``cv2_rubik_member``
finds it there)."""

import gzip
import hashlib
import os

import cv2
import numpy as np
import pytest

from yolov6_tpu_torch.utils import text
from yolov6_tpu_torch.utils.data_config import load_data_config

from torch_port_utils import REPO_ROOT

SCALES = [lw / 3 for lw in range(2, 21)] + [0.5, 0.55, 0.7, 1.0, 2.5]
FACES = [cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_COMPLEX]
THICKNESS = [1, 2, 3, 5]
ASCII = "".join(chr(c) for c in range(32, 127))
RUBIK_SHA256 = "7cdd1f5e7f04df8091c98e3ff2060b5f0d231b2582e344e7727581b7841c7b77"


def cv2_rubik_member() -> bytes:
    """The gzip member named ``Rubik.ttf`` inside the installed cv2 binary,
    as it lies there: the extraction the committed font was made by."""
    import zlib

    binary = os.path.join(os.path.dirname(cv2.__file__), "cv2.abi3.so")
    with open(binary, "rb") as f:
        data = f.read()
    head = data.find(b"Rubik.ttf\x00") - 10  # a gzip header with FNAME
    assert head >= 0 and data[head:head + 4] == b"\x1f\x8b\x08\x08", "no Rubik.ttf in cv2"
    z = zlib.decompressobj(31)
    z.decompress(data[head:head + 1_000_000])
    return data[head:head + 1_000_000 - len(z.unused_data)]


def _labels():
    names = load_data_config(os.path.join(REPO_ROOT, "data", "coco.yaml"))["names"]
    return [f"{n} {s:.2f}" for n, s in zip(names, np.linspace(0.25, 1.0, len(names)))]


def _canvas(rng, h, w):
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 2)


def test_font_is_cv2s():
    """The committed gzip member is cv2's, byte for byte, and inflates to
    the TrueType file the README names."""
    with open(text.FONT, "rb") as f:
        committed = f.read()
    assert committed == cv2_rubik_member()
    assert hashlib.sha256(gzip.decompress(committed)).hexdigest() == RUBIK_SHA256


@pytest.mark.parametrize("face", FACES)
@pytest.mark.parametrize("thickness", THICKNESS)
def test_put_text_ascii_and_labels(face, thickness):
    """Every printable character and every COCO label at every scale of the
    grid, drawn into a canvas whose borders clip the text."""
    rng = np.random.default_rng(100 * face + thickness)
    labels = _labels()
    lines = [ASCII[i:i + 24] for i in range(0, len(ASCII), 24)]
    for k, scale in enumerate(SCALES):
        size = text.font_size(scale)
        for s in lines + labels[k::len(SCALES)]:
            (w, h), base = cv2.getTextSize(s, face, scale, thickness)
            canvas = _canvas(rng, h + base + 8, max(w // 2, 8))
            org = (int(rng.integers(-w // 2, 4)), int(rng.integers(h // 2, h + base + 6)))
            color = tuple(int(c) for c in rng.integers(0, 256, 3))
            want, got = canvas.copy(), canvas.copy()
            cv2.putText(want, s, org, face, scale, color, thickness, cv2.LINE_AA)
            text.put_text(got, s, org, face, scale, color, thickness, cv2.LINE_AA)
            assert np.array_equal(got, want), (s, scale, size, org)


@pytest.mark.parametrize("face", FACES)
def test_get_text_size_grid(face):
    """``((w, h), baseline)`` of every character alone, the printable set
    together and every COCO label, at every scale and thickness."""
    strings = list(ASCII) + [ASCII] + _labels()
    for scale in SCALES:
        for thickness in THICKNESS:
            for s in strings:
                (w, h), base = cv2.getTextSize(s, face, scale, thickness)
                assert text.get_text_size(s, face, scale, thickness) == ((w, h), base), (
                    s, scale, thickness)


@pytest.mark.parametrize("border", ["left", "top", "right", "bottom"])
def test_put_text_clipped_at_each_border(border):
    """A label that runs off one border, at a few scales: the pixels inside
    equal cv2's."""
    rng = np.random.default_rng(len(border))
    for scale in (0.5, 1.0, 2.5, 14 / 3):
        for face, thickness in ((0, 1), (0, 2), (3, 2)):
            s = "Wjg@ 0.91|"
            (w, h), base = cv2.getTextSize(s, face, scale, thickness)
            H, W = 2 * h, w
            org = {"left": (-w // 3, h), "right": (W - 2 * w // 3, h),
                   "top": (2, h // 3), "bottom": (2, H + base // 2 - 1)}[border]
            canvas = _canvas(rng, H, W)
            want, got = canvas.copy(), canvas.copy()
            cv2.putText(want, s, org, face, scale, (17, 250, 90), thickness, cv2.LINE_AA)
            text.put_text(got, s, org, face, scale, (17, 250, 90), thickness)
            assert np.array_equal(got, want), (border, scale, face, thickness)


def test_faces_flags_and_characters():
    """DUPLEX and TRIPLEX (600 and 800), FONT_ITALIC and the line type
    change what cv2 changes; Latin characters of Rubik outside ASCII equal
    cv2's; a character outside Rubik counts and draws as '?' (cv2 uses its
    Unicode face there); the other Hershey faces raise."""
    rng = np.random.default_rng(7)
    cases = [("Duplex 0.50", cv2.FONT_HERSHEY_DUPLEX, 1), ("Triplex 0.50", cv2.FONT_HERSHEY_TRIPLEX, 2),
             ("italic 0.77", cv2.FONT_HERSHEY_SIMPLEX | cv2.FONT_ITALIC, 1),
             ("café Ångström naïve ½°C €5", 0, 2),
             ("ÆØÅ æøå ĞİŞ При", 3, 2)]
    for s, face, thickness in cases:
        for scale, line_type in ((0.6, cv2.LINE_8), (1.7, cv2.LINE_AA)):
            (w, h), base = cv2.getTextSize(s, face, scale, thickness)
            assert text.get_text_size(s, face, scale, thickness) == ((w, h), base)
            canvas = _canvas(rng, h + base + 6, w + 6)
            want, got = canvas.copy(), canvas.copy()
            cv2.putText(want, s, (3, h + 2), face, scale, (250, 30, 200), thickness, line_type)
            text.put_text(got, s, (3, h + 2), face, scale, (250, 30, 200), thickness, line_type)
            assert np.array_equal(got, want), s
    a, b = _canvas(rng, 40, 80), None
    b = a.copy()
    text.put_text(a, "x人Ω\t", (2, 30), 0, 1.0, (0, 0, 255), 1)
    text.put_text(b, "x???", (2, 30), 0, 1.0, (0, 0, 255), 1)
    assert np.array_equal(a, b)
    assert text.get_text_size("x人", 0, 1.0, 1) == text.get_text_size("x?", 0, 1.0, 1)
    for face in (cv2.FONT_HERSHEY_PLAIN, cv2.FONT_HERSHEY_COMPLEX_SMALL,
                 cv2.FONT_HERSHEY_SCRIPT_SIMPLEX, cv2.FONT_HERSHEY_SCRIPT_COMPLEX):
        with pytest.raises(ValueError, match="font face"):
            text.get_text_size("x", face, 1.0, 1)
    with pytest.raises(ValueError, match="HxWx3"):
        text.put_text(np.zeros((8, 8), np.uint8), "x", (0, 6), 0, 0.3, 255)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises; nothing falls back to another font."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(text, "_lib", None)
    monkeypatch.setattr(text, "library_path", lambda source: str(tmp_path / "never_built.so"))
    with pytest.raises(RuntimeError, match="failed"):
        text.get_text_size("x", 0, 1.0, 1)
