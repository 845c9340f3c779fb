"""Inference CLI (port of tools/infer.py):

    python -m yolov6_tpu_torch.tools.infer --weights <state dict>.pt \
        --config configs/yolov6s.py --source data/images --save-txt

``--weights`` is a ``torch.save``d state dict (``utils/checkpoint.py``).
``--device`` defaults to ``cuda`` and raises without it; ``--device cpu``
runs on the CPU. ``--source`` is an image, a video (``.mp4``, ``.mov``,
``.avi``, ``.mkv`` holding MPEG-4 Part 2 or Motion JPEG) or a directory of
both. A drawn image is written under its source's name and format; a video's
drawn frames, each with the FPS overlay, go to ``<stem>.mp4`` at the
source's fps and size; ``--save-txt`` writes ``labels/<stem>.txt`` (a
video's rows frame after frame), as the JAX CLI does. Not ported:
``--webcam`` and ``--view-img`` (a camera and a window; they raise
``NotImplementedError``).
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp

from yolov6_tpu_torch.core.inferer import Inferer
from yolov6_tpu_torch.utils.general import increment_name

LOGGER = logging.getLogger(__name__)


def get_args_parser(add_help=True):
    parser = argparse.ArgumentParser(description="YOLOv6 inference (PyTorch port)",
                                     add_help=add_help)
    parser.add_argument("--weights", type=str, default="weights/yolov6s.pt",
                        help="a torch.save'd state dict (bare, or under 'ema'/'model') or an "
                             "upstream YOLOv6 .pt")
    parser.add_argument("--config", type=str, default="configs/yolov6s.py")
    parser.add_argument("--source", type=str, default="data/images")
    parser.add_argument("--webcam", action="store_true")
    parser.add_argument("--webcam-addr", type=str, default="0")
    parser.add_argument("--yaml", type=str, default="data/coco.yaml")
    parser.add_argument("--img-size", nargs="+", type=int, default=[640, 640])
    parser.add_argument("--conf-thres", type=float, default=0.4)
    parser.add_argument("--iou-thres", type=float, default=0.45)
    parser.add_argument("--max-det", type=int, default=1000)
    parser.add_argument("--save-dir", type=str, default=None, help="directory to save predictions")
    parser.add_argument("--save-txt", action="store_true")
    parser.add_argument("--not-save-img", action="store_true")
    parser.add_argument("--view-img", action="store_true")
    parser.add_argument("--classes", nargs="+", type=int, default=None)
    parser.add_argument("--agnostic-nms", action="store_true")
    parser.add_argument("--project", default="runs/inference")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--hide-labels", default=False, action="store_true")
    parser.add_argument("--hide-conf", default=False, action="store_true")
    parser.add_argument("--half", action="store_true", help="bf16 inference")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; cuda raises when there is no GPU")
    return parser


def run(args):
    if args.save_dir is None:
        save_dir = str(increment_name(osp.join(args.project, args.name)))
    else:
        save_dir = args.save_dir
    save_img = not args.not_save_img
    if save_img or args.save_txt:
        os.makedirs(save_dir, exist_ok=True)

    if isinstance(args.img_size, int):
        args.img_size = [args.img_size, args.img_size]
    elif len(args.img_size) == 1:
        args.img_size = args.img_size * 2

    inferer = Inferer(
        args.source, args.webcam, args.webcam_addr, args.weights, args.config,
        args.yaml, args.img_size, args.half, device=args.device,
    )
    inferer.infer(
        args.conf_thres, args.iou_thres, args.classes, args.agnostic_nms,
        args.max_det, save_dir, args.save_txt, save_img,
        args.hide_labels, args.hide_conf, args.view_img,
    )
    if args.save_txt or save_img:
        LOGGER.info(f"Results saved to {save_dir}")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = get_args_parser().parse_args()
    LOGGER.info(args)
    run(args)
