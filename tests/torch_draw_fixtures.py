"""Writes ``tests/data/torch_draw/hashes.json``: a fixed set of drawing cases
(text, boxes, labels, shapes, the FPS overlay) and, for each, the SHA-256 of
the image the JAX package's calls draw with cv2 5.0 (``cv2.putText``,
``cv2.rectangle``, ``cv2.circle``, ``cv2.fillPoly``, and
``yolov6_tpu/core/inferer.py``'s ``plot_box_and_label`` and ``draw_text``)
on the synthetic generator's background; and the SHA-256 of the first
images of the JAX generator (``yolov6_tpu/data/synth_detect.py``) before
its JPEG encode. ``chip_smoke.py`` [38] holds the port's drawing, built by
the card machine's compiler, to those hashes (``draw_case`` there is the
port's side of each call); ``tests/test_torch_draw_aa.py`` holds both sides
to them here. Run from the repository root to rewrite the file:

    python tests/torch_draw_fixtures.py
"""

import hashlib
import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(HERE)
OUT = os.path.join(HERE, "data", "torch_draw", "hashes.json")
SYNTH = dict(seed=0, img_size=160, n=4, nc=4)

# each case: a seeded background of (h, w), then calls in order
CASES = [
    {"name": "labels_lw2_3_4", "seed": 1, "size": [240, 320], "calls": [
        ["plot_box_and_label", 2, [20.4, 30.9, 140.2, 150.7], "person 0.87", [56, 56, 255]],
        ["plot_box_and_label", 3, [150, 12, 300, 120], "traffic light 0.45", [151, 157, 255]],
        ["plot_box_and_label", 4, [60, 170, 250, 235], "bear 1.00", [31, 112, 255]]]},
    {"name": "labels_lw5_6_9", "seed": 2, "size": [300, 420], "calls": [
        ["plot_box_and_label", 5, [10, 60, 200, 280], "motorcycle 0.33", [29, 178, 255]],
        ["plot_box_and_label", 6, [180, 5, 410, 120], "cell phone 0.50", [49, 210, 207]],
        ["plot_box_and_label", 9, [230, 150, 400, 290], "toothbrush 0.91", [10, 249, 72]]]},
    {"name": "labels_clipped_lw13", "seed": 3, "size": [200, 260], "calls": [
        ["plot_box_and_label", 13, [-30, 150, 120, 260], "airplane 0.66", [23, 204, 146]],
        ["plot_box_and_label", 2, [200, -10, 300, 60], "dog 0.25", [134, 219, 61]],
        ["plot_box_and_label", 3, [0, 0, 259, 199], "", [52, 147, 26]]]},
    {"name": "text_simplex", "seed": 4, "size": [160, 420], "calls": [
        ["put_text", "FPS: 29.9 !\"#$%&'()*+,-./", [4, 30], 0, 0.7, [0, 255, 0], 2],
        ["put_text", "0123456789:;<=>?@ABCDEFGHIJKLM", [4, 70], 0, 0.5, [255, 255, 255], 1],
        ["put_text", "NOPQRSTUVWXYZ[\\]^_`abcdefghij", [4, 110], 0, 2.5 / 3, [20, 20, 200], 3],
        ["put_text", "klmnopqrstuvwxyz{|}~ img_000.png", [4, 150], 0, 1.0, [0, 255, 255], 5]]},
    {"name": "text_complex", "seed": 5, "size": [180, 400], "calls": [
        ["put_text", "person 0.87 car 0.12", [-20, 40], 3, 2 / 3, [255, 255, 255], 1],
        ["put_text", "sports ball 0.50", [8, 95], 3, 4 / 3, [220, 220, 220], 3],
        ["put_text", "val_img_3: 0.99", [300, 140], 3, 0.5, [60, 200, 90], 1],
        ["put_text", "Wjg@|", [350, 190], 3, 5 / 3, [200, 100, 0], 4]]},
    {"name": "text_duplex_triplex_italic", "seed": 6, "size": [120, 300], "calls": [
        ["put_text", "duplex 0.5", [5, 30], 2, 0.9, [250, 40, 160], 1],
        ["put_text", "triplex 0.5", [5, 70], 4, 0.9, [40, 250, 160], 2],
        ["put_text", "italic ignored", [5, 110], 16, 0.9, [0, 0, 0], 1]]},
    {"name": "boxes_aa", "seed": 7, "size": [200, 260], "calls": [
        ["rectangle", [10, 12], [100, 90], [0, 0, 255], 1, 16],
        ["rectangle", [120, 10], [250, 60], [0, 255, 0], 2, 16],
        ["rectangle", [130, 80], [60, 150], [255, 0, 0], 3, 16],
        ["rectangle", [200, 100], [280, 220], [0, 255, 255], 8, 16],
        ["rectangle", [20, 160], [110, 190], [255, 0, 255], -1, 16],
        ["rectangle", [-10, -10], [30, 40], [255, 255, 0], 5, 16]]},
    {"name": "boxes_line8", "seed": 8, "size": [150, 200], "calls": [
        ["rectangle", [10, 10], [120, 100], [0, 255, 0], 2, 8],
        ["rectangle", [150, 20], [90, 140], [255, 255, 255], 1, 8],
        ["rectangle", [5, 110], [60, 145], [0, 0, 0], -1, 8]]},
    {"name": "shapes", "seed": 9, "size": [220, 300], "calls": [
        ["circle", [60, 60], 45, [40, 40, 230], -1],
        ["circle", [160, 70], 40, [40, 210, 230], 13],
        ["fill_poly", [[[240, 20], [200, 100], [280, 100]]], [230, 80, 40]],
        ["circle", [290, 200], 35, [0, 200, 0], 3],
        ["fill_poly", [[[10, 210], [70, 120], [130, 215], [60, 180]]], [200, 0, 200]],
        ["circle", [150, 170], 2, [255, 255, 255], -1]]},
    {"name": "overlay", "seed": 10, "size": [120, 240], "calls": [
        ["draw_text", "FPS: 29.9", [20, 20], 1.0, 2, [204, 85, 17], [255, 255, 255]],
        ["draw_text", "FPS: 7.1", [120, 70], 0.6, 1, [0, 255, 0], [0, 0, 0]]]},
]


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def draw_case_cv2(case) -> np.ndarray:
    """The case drawn by cv2 5.0 and the JAX package's draw functions."""
    sys.path.insert(0, REPO_ROOT)
    import conftest  # noqa: F401  (JAX on the CPU)
    from yolov6_tpu.core.inferer import Inferer
    from yolov6_tpu.data.synth_detect import _background

    h, w = case["size"]
    img = _background(np.random.default_rng(case["seed"]), h, w)
    for name, *a in case["calls"]:
        if name == "plot_box_and_label":
            lw, box, label, color = a
            Inferer.plot_box_and_label(img, lw, box, label, color=tuple(color))
        elif name == "put_text":
            text, org, face, scale, color, th = a
            cv2.putText(img, text, tuple(org), face, scale, tuple(color), th, cv2.LINE_AA)
        elif name == "rectangle":
            p1, p2, color, th, line_type = a
            cv2.rectangle(img, tuple(p1), tuple(p2), tuple(color), th, line_type)
        elif name == "circle":
            c, r, color, th = a
            cv2.circle(img, tuple(c), r, tuple(color), th, cv2.LINE_AA)
        elif name == "fill_poly":
            pts, color = a
            cv2.fillPoly(img, [np.array(p, np.int32) for p in pts], tuple(color), cv2.LINE_AA)
        elif name == "draw_text":
            text, pos, scale, th, fg, bg = a
            Inferer.draw_text(img, text, pos=tuple(pos), font_scale=scale, font_thickness=th,
                              text_color=tuple(fg), text_color_bg=tuple(bg))
        else:
            raise ValueError(name)
    return img


def synth_cv2(tmp_dir: str) -> list:
    """The JAX generator's first ``SYNTH['n']`` train images, as its
    ``cv2.imwrite`` receives them."""
    sys.path.insert(0, REPO_ROOT)
    import conftest  # noqa: F401
    import yolov6_tpu.data.synth_detect as jax_synth

    images, real = [], jax_synth.cv2.imwrite
    jax_synth.cv2.imwrite = lambda path, img, *a: images.append(img.copy()) or True
    try:
        jax_synth.generate_split(os.path.join(tmp_dir, "i"), os.path.join(tmp_dir, "l"),
                                 SYNTH["n"], SYNTH["img_size"], SYNTH["nc"],
                                 np.random.default_rng(SYNTH["seed"]), "train")
    finally:
        jax_synth.cv2.imwrite = real
    return images


def main() -> None:
    import tempfile

    cases = [dict(case, sha256=digest(draw_case_cv2(case))) for case in CASES]
    with tempfile.TemporaryDirectory() as tmp:
        synth = dict(SYNTH, sha256=[digest(img) for img in synth_cv2(tmp)])
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"opencv": cv2.__version__, "cases": cases, "synth": synth}, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}: {len(cases)} cases and {SYNTH['n']} synthetic images")


if __name__ == "__main__":
    main()
