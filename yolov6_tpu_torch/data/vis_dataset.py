"""Draw a dataset's YOLO labels on its images (port of
yolov6_tpu/data/vis_dataset.py:13-52; reference: yolov6/data/vis_dataset.py).

    python -m yolov6_tpu_torch.data.vis_dataset --img_dir <images> \\
        --label_dir <labels> [--out_dir vis_out]

Each of the first ``max_images`` images (by name) is read by
``data/image_io.py::imread`` (PNG, JPEG and BMP; another format raises
``ValueError``, as in the loaders), each label's box is drawn 2 px wide as
``cv2.rectangle`` draws it (``utils/draw.py::rectangle_line8``) in the
colour of its class from ``default_rng(0)``, its class name or id above it
as ``cv2.putText`` writes it (``utils/text.py``), and the result is written under the image's name
in its format (``image_io.imwrite``, as the JAX tool's ``cv2.imwrite``).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from yolov6_tpu_torch.data.image_io import imread, imwrite
from yolov6_tpu_torch.utils.draw import rectangle_line8
from yolov6_tpu_torch.utils.text import FONT_HERSHEY_SIMPLEX, put_text


def visualize(img_dir: str, label_dir: str, out_dir: str, class_names=None, max_images=20):
    """Returns the paths written."""
    os.makedirs(out_dir, exist_ok=True)
    imgs = sorted(
        f for f in os.listdir(img_dir)
        if f.rsplit(".", 1)[-1].lower() in ("jpg", "jpeg", "png", "bmp")
    )[:max_images]
    rng = np.random.default_rng(0)
    colors = rng.integers(0, 255, (len(class_names or []) or 80, 3))
    written = []
    for name in imgs:
        img = imread(osp.join(img_dir, name))
        h, w = img.shape[:2]
        lb_path = osp.join(label_dir, name.rsplit(".", 1)[0] + ".txt")
        if osp.exists(lb_path):
            with open(lb_path) as f:
                for line in f:
                    vals = line.split()
                    if len(vals) != 5:
                        continue
                    cls, cx, cy, bw, bh = float(vals[0]), *map(float, vals[1:])
                    x1, y1 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
                    x2, y2 = int((cx + bw / 2) * w), int((cy + bh / 2) * h)
                    color = tuple(int(c) for c in colors[int(cls) % len(colors)])
                    rectangle_line8(img, (x1, y1), (x2, y2), color, 2)
                    label = class_names[int(cls)] if class_names else str(int(cls))
                    put_text(img, label, (x1, max(y1 - 4, 10)), FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
        out = osp.join(out_dir, name)
        imwrite(out, img)
        written.append(out)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description="draw a dataset's YOLO labels")
    parser.add_argument("--img_dir", required=True)
    parser.add_argument("--label_dir", required=True)
    parser.add_argument("--out_dir", default="vis_out")
    args = parser.parse_args(argv)
    visualize(args.img_dir, args.label_dir, args.out_dir)


if __name__ == "__main__":
    main()
