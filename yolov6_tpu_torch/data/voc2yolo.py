"""VOC XML -> YOLO txt converter (the port's copy of
yolov6_tpu/data/voc2yolo.py; reference: yolov6/data/voc2yolo.py). XML only:
it reads no image.

    python -m yolov6_tpu_torch.data.voc2yolo --voc_path <VOCdevkit dir> --out_dir <dir>

writes ``<out_dir>/<name>.txt`` for each ``Annotations/<name>.xml``: a line a
non-difficult object of a VOC class, ``cls cx cy w h`` normalised, 6 decimals.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import xml.etree.ElementTree as ET

VOC_NAMES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def convert_box(size, box):
    dw, dh = 1.0 / size[0], 1.0 / size[1]
    x = (box[0] + box[1]) / 2.0 - 1
    y = (box[2] + box[3]) / 2.0 - 1
    w = box[1] - box[0]
    h = box[3] - box[2]
    return x * dw, y * dh, w * dw, h * dh


def convert_label(xml_path: str, out_txt: str, class_names=VOC_NAMES):
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w = int(size.find("width").text)
    h = int(size.find("height").text)
    lines = []
    for obj in root.iter("object"):
        cls = obj.find("name").text
        if cls not in class_names or int(obj.find("difficult").text) == 1:
            continue
        xmlbox = obj.find("bndbox")
        bb = convert_box(
            (w, h),
            [float(xmlbox.find(t).text) for t in ("xmin", "xmax", "ymin", "ymax")],
        )
        lines.append(f"{class_names.index(cls)} " + " ".join(f"{v:.6f}" for v in bb))
    with open(out_txt, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def main(argv=None):
    parser = argparse.ArgumentParser(description="VOC XML to YOLO labels")
    parser.add_argument("--voc_path", required=True, help="VOCdevkit dir")
    parser.add_argument("--out_dir", required=True)
    args = parser.parse_args(argv)
    ann_dir = osp.join(args.voc_path, "Annotations")
    os.makedirs(args.out_dir, exist_ok=True)
    for name in sorted(os.listdir(ann_dir)):
        if name.endswith(".xml"):
            convert_label(osp.join(ann_dir, name),
                          osp.join(args.out_dir, name.replace(".xml", ".txt")))


if __name__ == "__main__":
    main()
