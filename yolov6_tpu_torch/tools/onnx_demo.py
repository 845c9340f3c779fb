"""Standalone ONNX inference demo (port of tools/onnx_demo.py; reference
deploy/ONNX/OpenCV/yolov6.py): an exported ONNX file as a complete detector,
run as torch ops by ``export/torch_export.py::OnnxTorchModule`` on
``--device`` (default ``cuda``, as the other CLIs of the port; swap it for an
``onnxruntime.InferenceSession`` where one is installed).

    python -m yolov6_tpu_torch.tools.export --weights best.pt \
        --config configs/yolov6s.py --format onnx --output model.onnx
    python -m yolov6_tpu_torch.tools.onnx_demo --model model.onnx \
        --source img.jpg --save out.png [--device cpu]

Images are read by ``data/image_io.py`` and letterboxed by the port (cv2's
pixels, bit for bit), boxes drawn by ``utils/draw.py`` and saved by
``image_io.imwrite`` in the format ``--save``'s suffix names (JPEG, PNG, BMP). A
plain file's predictions go through the port's ``non_max_suppression``
(multi-label, class-offset greedy over every candidate above
``--conf-thres``, the reference's utils/nms.py:31-105), an end2end file's
``NonMaxSuppression`` through the same keep: on the card, the CUDA kernel.
A video (``--video`` or a video suffix) runs ``run_video``, the JAX demo's
frame loop: each frame read by ``data/video.py::VideoCapture``, its
detections drawn, the running FPS written at (10, 25) by ``put_text``, and
the frame written by ``data/video.py::VideoWriter`` to ``--save`` (MPEG-4
Part 2 in MP4) at the source's fps and size; ``--max-frames`` stops early.
"""

from __future__ import annotations

import argparse
import os.path as osp
import time

import numpy as np
import torch

from yolov6_tpu_torch.core.inferer import Inferer
from yolov6_tpu_torch.data.data_augment import letterbox
from yolov6_tpu_torch.data.image_io import imread, imwrite
from yolov6_tpu_torch.data.video import (
    CAP_PROP_FPS, CAP_PROP_FRAME_HEIGHT, CAP_PROP_FRAME_WIDTH, VideoCapture, VideoWriter,
)
from yolov6_tpu_torch.export.torch_export import OnnxTorchModule
from yolov6_tpu_torch.ops.nms import non_max_suppression
from yolov6_tpu_torch.utils.device import resolve_device
from yolov6_tpu_torch.utils.draw import plot_box_and_label
from yolov6_tpu_torch.utils.text import FONT_HERSHEY_SIMPLEX, put_text

VIDEO_SUFFIXES = (".mp4", ".avi", ".mov", ".mkv", ".webm")
MAX_DET = 300


def infer_frame(runner, img_src, h, w, conf_thres, iou_thres, device="cuda"):
    """One frame through letterbox -> graph -> NMS -> source-pixel dets, the
    graph (an ``OnnxTorchModule``) and the NMS on ``device``."""
    img = letterbox(img_src, (h, w), auto=False)[0]
    x = img[..., ::-1].astype(np.float32)[None] / 255.0  # BGR->RGB, NHWC
    with torch.no_grad():
        outs = runner(torch.from_numpy(np.ascontiguousarray(x)).to(device))
    if isinstance(outs, (tuple, list)) and len(outs) == 4:
        # end2end artifact: (num_dets, boxes, scores, classes)
        num, boxes, scores, classes = (o[0].cpu().numpy() for o in outs)
        n = int(num[0])
        dets = np.concatenate(
            [boxes[:n], scores[:n, None], classes[:n, None].astype(np.float32)], axis=1)
    else:
        pred = outs[0] if isinstance(outs, (tuple, list)) else outs
        # every candidate above conf_thres, as the reference's NMS takes them
        dets, valid = non_max_suppression(
            pred.float(), conf_thres, iou_thres, max_det=MAX_DET,
            max_nms=pred.shape[1] * (pred.shape[2] - 5), multi_label=True, anchor_topc=0)
        dets = dets[0][valid[0]].cpu().numpy()
    if len(dets):
        dets[:, :4] = Inferer.rescale((h, w), dets[:, :4], img_src.shape[:2])
    return dets


def draw_dets(img_src, dets, names, verbose=True):
    for *xyxy, conf, cls in dets:
        label = names[int(cls)] if names and int(cls) < len(names) else f"class{int(cls)}"
        plot_box_and_label(img_src, max(round(sum(img_src.shape) / 2 * 0.003), 2),
                           np.asarray(xyxy), f"{label} {conf:.2f}",
                           color=Inferer.generate_colors(int(cls), bgr=True))
        if verbose:
            print(f"{label}: conf={conf:.3f} box={[round(float(v), 1) for v in xyxy]}")


def run_video(runner, h, w, args, device="cuda"):
    """The JAX demo's video loop (tools/onnx_demo.py:98-130): every frame
    through ``infer_frame`` on ``device``, drawn with its detections and the
    running FPS, and written to ``args.save`` when it is set. Returns
    ``(frames, detections)``."""
    cap = VideoCapture(args.source)
    fps = cap.get(CAP_PROP_FPS) or 25.0
    size = (int(cap.get(CAP_PROP_FRAME_WIDTH)), int(cap.get(CAP_PROP_FRAME_HEIGHT)))
    writer = VideoWriter(args.save, fps, size) if args.save else None
    n_frames, n_dets, t0 = 0, 0, time.perf_counter()
    try:
        while True:
            ok, frame = cap.read()
            if not ok or (args.max_frames and n_frames >= args.max_frames):
                break
            dets = infer_frame(runner, frame, h, w, args.conf_thres, args.iou_thres, device)
            draw_dets(frame, dets, args.class_names, verbose=False)
            cur_fps = (n_frames + 1) / (time.perf_counter() - t0)
            put_text(frame, f"FPS: {cur_fps:.1f}", (10, 25), FONT_HERSHEY_SIMPLEX, 0.7,
                     (0, 255, 0), 2)
            if writer is not None:
                writer.write(frame)
            n_frames += 1
            n_dets += len(dets)
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    if writer is not None:
        print(f"saved to {args.save}")
    print(f"{n_frames} frames, {n_dets} detections")
    return n_frames, n_dets


def get_args_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="ONNX file from tools/export.py")
    ap.add_argument("--source", required=True, help="input image or video")
    ap.add_argument("--save", default=None,
                    help="output image (.jpg, .png or .bmp) or video (.mp4) path")
    ap.add_argument("--conf-thres", type=float, default=0.4)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--class-names", nargs="*", default=None)
    ap.add_argument("--video", action="store_true",
                    help="treat --source as a video: per-frame loop with FPS overlay")
    ap.add_argument("--max-frames", type=int, default=0,
                    help="video mode: stop after N frames (0 = all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(args):
    """Run one image, and return its detections ``[n, 6]`` in source pixels;
    or a video (``run_video``), and return ``(frames, detections)``."""
    device = resolve_device(args.device)
    with open(args.model, "rb") as f:
        runner = OnnxTorchModule(f.read())
    _, _, in_shape = runner.parsed.inputs[0]
    h, w = int(in_shape[1]), int(in_shape[2])
    if args.video or osp.splitext(args.source)[-1].lower() in VIDEO_SUFFIXES:
        return run_video(runner, h, w, args, device)
    img_src = imread(args.source)
    dets = infer_frame(runner, img_src, h, w, args.conf_thres, args.iou_thres, device)
    draw_dets(img_src, dets, args.class_names)
    print(f"{len(dets)} detections")
    if args.save:
        imwrite(args.save, img_src)
        print(f"saved to {args.save}")
    return dets


if __name__ == "__main__":
    main(get_args_parser().parse_args())
