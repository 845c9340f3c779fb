"""NCNN-style runner for the exported TorchScript artifact (port of
tools/infer_torchscript.py; reference deploy/NCNN/infer-ncnn-model.py:103-262):

    python -m yolov6_tpu_torch.tools.export --format torchscript --weights w.pt \
        --config configs/yolov6_lite/yolov6_lite_s.py --img-size 320 --device cpu
    python -m yolov6_tpu_torch.tools.infer_torchscript data/images/image1.jpg \
        w.torchscript.pt --out-dir output [--device cpu]

The same aspect-keeping resize and centred 114-pad (ncnn's
``from_pixels_resize`` + ``copy_make_border``), here by the port's
``data/image_io.py`` reader and ``resize_linear`` (cv2's INTER_LINEAR, bit
for bit) in place of cv2; the graph through ``torch.jit.load`` onto
``--device`` (default ``cuda``, as the other CLIs of the port; export the
file on the same device, since a trace keeps the device of its constants); a
class-aware greedy NMS (the port's keep, ``ops/cuda/nms_kernel.py::greedy_nms``,
over class-offset boxes: the CUDA kernel on the card) in place of cv2's
``NMSBoxesBatched``; the reference's floor/ceil clamping on
rescale (:240-246); the boxes drawn with ``utils/draw.py`` and written as
``<out-dir>/<source name>`` in the source's format (``image_io.imwrite``). The TorchScript export already holds the decode
(model+decode -> ``[b, A, 5+nc]``), so the host starts at the confidence
filter. A video file raises ``FileNotFoundError``, as the JAX tool's
``cv2.imread`` finds no image in it.
"""

from __future__ import annotations

import argparse
import math
import os
import os.path as osp

import numpy as np
import torch

from yolov6_tpu_torch.data.data_augment import resize_linear
from yolov6_tpu_torch.data.image_io import imread, imwrite
from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
from yolov6_tpu_torch.utils.device import resolve_device
from yolov6_tpu_torch.utils.draw import rectangle
from yolov6_tpu_torch.utils.text import FONT_HERSHEY_SIMPLEX, put_text

CONF_THRES = 0.45
IOU_THRES = 0.65
VIDEO_SUFFIXES = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def parse_args(argv=None):
    p = argparse.ArgumentParser("TorchScript NCNN-style runner")
    p.add_argument("img", help="image file")
    p.add_argument("model", help="TorchScript artifact (*.torchscript.pt)")
    p.add_argument("--out-dir", default="./output")
    p.add_argument("--img-size", nargs="+", type=int, default=[320, 320],
                   help="net input height and width (must match the export)")
    p.add_argument("--conf-thres", type=float, default=CONF_THRES)
    p.add_argument("--iou-thres", type=float, default=IOU_THRES)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if len(args.img_size) == 1:
        args.img_size = args.img_size * 2
    return args


def preprocess(img: np.ndarray, net_h: int, net_w: int):
    """ncnn-style preproc: scale the long side to net size, centre-pad with
    114 (reference infer-ncnn-model.py:193-225). The traced graph is
    fixed-shape, so padding fills the full net square."""
    img_h, img_w = img.shape[:2]
    if img_w > img_h:
        scale = float(net_w) / img_w
        w, h = net_w, int(img_h * scale)
    else:
        scale = float(net_h) / img_h
        h, w = net_h, int(img_w * scale)
    resized = resize_linear(img, (w, h)) if (w, h) != (img_w, img_h) else img
    wpad, hpad = net_w - w, net_h - h
    padded = np.full((net_h, net_w, 3), 114, np.uint8)
    padded[hpad // 2:hpad // 2 + h, wpad // 2:wpad // 2 + w] = resized
    # BGR -> RGB, [0,1], NHWC float (the export contract)
    x = padded[:, :, ::-1].astype(np.float32) / 255.0
    return x[None], scale, wpad, hpad


def decode_predictions(preds: np.ndarray, conf_thres: float, iou_thres: float, device):
    """Confidence filter + class-aware greedy NMS on the decoded [A, 5+nc]
    output (reference NMSBoxesBatched flow, infer-ncnn-model.py:149-171):
    the best class an anchor, boxes offset by class, the greedy keep over
    the survivors by descending score, on ``device``."""
    boxes_xywh = preds[:, :4]  # cx,cy,w,h in net pixels
    scores_all = preds[:, 4:5] * preds[:, 5:]
    labels = scores_all.argmax(-1)
    scores = scores_all.max(-1)
    m = scores > conf_thres
    if not m.any():
        return [], [], []
    boxes_xywh, scores, labels = boxes_xywh[m], scores[m], labels[m]
    xyxy = np.concatenate([boxes_xywh[:, :2] - boxes_xywh[:, 2:] / 2,
                           boxes_xywh[:, :2] + boxes_xywh[:, 2:] / 2], 1).astype(np.float32)
    off = max(1024.0, float(preds[:, 2:4].max()) + 1.0)
    shifted = torch.from_numpy(xyxy + (labels * off)[:, None].astype(np.float32))
    idx, valid = greedy_nms(shifted[None].to(device),
                            torch.from_numpy(scores.astype(np.float32))[None].to(device),
                            len(scores), iou_thres)
    keep = idx[0][valid[0]].cpu().numpy()
    return ([xyxy[i] for i in keep], [float(scores[i]) for i in keep],
            [int(labels[i]) for i in keep])


def run(img_path: str, model_path: str, img_size, conf_thres=CONF_THRES, iou_thres=IOU_THRES,
        out_dir: str | None = None, device="cuda"):
    """Full single-image flow on ``device``; returns [n, 6] xyxy/conf/cls in
    source pixels."""
    if osp.splitext(img_path)[-1].lower() in VIDEO_SUFFIXES:
        # the JAX tool reads its one image with cv2.imread, which gives None
        # for a video, and raises FileNotFoundError
        raise FileNotFoundError(img_path)
    device = resolve_device(device)
    net_h, net_w = img_size
    img = imread(img_path)
    img_h, img_w = img.shape[:2]
    x, scale, wpad, hpad = preprocess(img, net_h, net_w)
    module = torch.jit.load(model_path, map_location=device)
    with torch.no_grad():
        preds = module(torch.from_numpy(np.ascontiguousarray(x)).to(device))
    preds = (preds[0] if isinstance(preds, (tuple, list)) else preds).cpu().numpy()
    boxes, scores, labels = decode_predictions(preds[0], conf_thres, iou_thres, device)
    dets = []
    draw = img.copy()
    for box, score, label in zip(boxes, scores, labels):
        # unpad + unscale with the reference's floor/ceil clamping (:240-246)
        x0 = math.floor(min(max((box[0] - wpad / 2) / scale, 1), img_w - 1))
        y0 = math.floor(min(max((box[1] - hpad / 2) / scale, 1), img_h - 1))
        x1 = math.ceil(min(max((box[2] - wpad / 2) / scale, 1), img_w - 1))
        y1 = math.ceil(min(max((box[3] - hpad / 2) / scale, 1), img_h - 1))
        dets.append([x0, y0, x1, y1, score, label])
        rectangle(draw, (x0, y0), (x1, y1), (0, 255, 0), 2)
        put_text(draw, f"{label}: {score:.2f}", (x0, max(y0 - 5, 1)), FONT_HERSHEY_SIMPLEX, 0.5,
                 (0, 255, 255), 2)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        imwrite(osp.join(out_dir, osp.basename(img_path)), draw)
    return np.asarray(dets, np.float32).reshape(-1, 6)


def main(args):
    dets = run(args.img, args.model, args.img_size, args.conf_thres, args.iou_thres,
               args.out_dir, args.device)
    for x0, y0, x1, y1, score, label in dets:
        print(f"det class={int(label)} conf={score:.4f} "
              f"box={x0:.0f},{y0:.0f},{x1:.0f},{y1:.0f}")
    print(f"num_dets={len(dets)}")
    return dets


if __name__ == "__main__":
    main(parse_args())
