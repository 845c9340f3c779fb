"""Training CLI (port of tools/train.py):

    python -m yolov6_tpu_torch.tools.train --data-path <set>/data.json \
        --conf-file configs/yolov6s.py --img-size 640 --batch-size 32 --bf16

``--device`` defaults to ``cuda`` and raises without it. A run writes under
``<output-dir>/<name>[n]/``: ``args.yaml`` and ``weights/`` (``last_ckpt.pt``,
``best_ckpt.pt``, ``<epoch>_ckpt.pt`` for the last ``--save_ckpt_on_last_n_epoch``
epochs, ``best_stop_aug_ckpt.pt``); the final ``last_ckpt.pt`` and
``best_ckpt.pt`` hold the EMA only, and ``tools/eval.py`` reads them.
``--resume [ckpt]`` continues a run from its checkpoint (the latest
``last*_ckpt*`` under the working directory without one), with the run's
saved ``args.yaml`` winning over the command line. The YOLOv6 v3.0 recipes:
``--fuse_ab`` (anchor-aided training), then ``--distill --teacher_model_path
<the fuse-AB run's best_ckpt.pt> [--distill_feat] [--temperature T]`` (for N
and S with the DFL config, ``use_dfl=True`` and ``reg_max=16``); a lite config
(``--img-size 320``) has neither recipe, and both raise ``ValueError``.
Quantisation, RepOpt's third stage on the ``configs/repopt/*_opt_qat.py``
configs: ``--quant --calib`` calibrates the train graph (``pretrained``'s
weights) and writes ``calib_ckpt.pt`` under ``ptq.calib_output_path``, then
returns; ``--quant`` trains from ``qat.calib_pt`` with the frozen ranges
(QAT). Data parallel, one process a rank:

    torchrun --nproc_per_node N -m yolov6_tpu_torch.tools.train ... --batch-size B

(B the global batch, B // N a rank; NCCL on the cards, gloo with ``--device
cpu``): the group is joined before the trainer is built, rank 0 names and
writes the run's directory, and N ranks take the step of one process at B
(``core/engine.py``). ``--cache ram|disk`` (``--cache-ram``) keeps the
decoded, pre-resized train images. Rank 0 writes a TensorBoard event file
(``events.out.tfevents.*``) into the run's directory: each epoch's APs,
losses and LRs, the val images with their predictions after each eval and,
with ``--write_trainbatch_tb``, each epoch's first train batch annotated;
view it with ``tensorboard --logdir runs/train`` where tensorboard is
installed. ``--specific-shape --height H --width W`` trains at H x W (each
a multiple of 32, at least ``--img-floor``; the in-training eval stays
square at ``--img-size``); ``--check-images`` decodes each image in the
scan, drops the ones that do not read and restores a JPEG without EOI in
place; ``--check-labels`` gives an image whose labels are out of range no
labels. ``--rect``, ``--dist_url`` and ``--gpu_count`` are parsed and
ignored, as the JAX CLI does. ``--ckpt-backend orbax`` raises
``NotImplementedError`` (``core/engine.py::check_supported``). Every flag of
the JAX CLI parses.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import random

import numpy as np

from yolov6_tpu_torch.core.engine import Trainer, check_supported
from yolov6_tpu_torch.parallel.dist import (
    broadcast_object, initialize_distributed, is_main_process,
)
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.events import LOGGER, load_yaml, save_yaml
from yolov6_tpu_torch.utils.general import check_img_size, find_latest_checkpoint, increment_name


def get_args_parser(add_help=True):
    parser = argparse.ArgumentParser(description="YOLOv6 training (PyTorch port)",
                                     add_help=add_help)
    parser.add_argument("--data-path", default="./data/coco.yaml", type=str,
                        help="dataset description, .json or flat .yaml")
    parser.add_argument("--conf-file", default="./configs/yolov6n.py", type=str)
    parser.add_argument("--img-size", default=640, type=int)
    parser.add_argument("--rect", action="store_true",
                        help="parsed and ignored, as the JAX trainer does")
    parser.add_argument("--batch-size", default=32, type=int)
    parser.add_argument("--epochs", default=400, type=int)
    parser.add_argument("--workers", default=8, type=int, help="loader threads")
    parser.add_argument("--eval-interval", default=20, type=int)
    parser.add_argument("--eval-final-only", action="store_true")
    parser.add_argument("--heavy-eval-range", default=50, type=int)
    parser.add_argument("--check-images", action="store_true",
                        help="decode every image in the scan; drop the unreadable, restore a "
                             "JPEG without EOI")
    parser.add_argument("--check-labels", action="store_true",
                        help="give an image whose labels are out of range no labels")
    parser.add_argument("--output-dir", default="./runs/train", type=str)
    parser.add_argument("--name", default="exp", type=str)
    parser.add_argument("--dist_url", default="env://", type=str,
                        help="parsed and ignored, as the JAX trainer does (torchrun sets the "
                             "group's address)")
    parser.add_argument("--gpu_count", type=int, default=0,
                        help="parsed and ignored, as the JAX trainer does")
    parser.add_argument("--resume", nargs="?", const=True, default=False)
    parser.add_argument("--write_trainbatch_tb", action="store_true")
    parser.add_argument("--stop_aug_last_n_epoch", default=15, type=int)
    parser.add_argument("--save_ckpt_on_last_n_epoch", default=-1, type=int)
    parser.add_argument("--distill", action="store_true")
    parser.add_argument("--distill_feat", action="store_true",
                        help="add the channel-wise KD on the neck maps")
    parser.add_argument("--quant", action="store_true")
    parser.add_argument("--calib", action="store_true")
    parser.add_argument("--teacher_model_path", type=str, default=None,
                        help="the distillation teacher's checkpoint (the port's .pt or an "
                             "upstream YOLOv6 .pt)")
    parser.add_argument("--temperature", type=int, default=20,
                        help="the distillation's softmax temperature")
    parser.add_argument("--fuse_ab", action="store_true")
    parser.add_argument("--bs_per_device", default=None, type=int,
                        help="per-device batch used to rescale lr0 (reference --bs_per_gpu)")
    parser.add_argument("--specific-shape", action="store_true",
                        help="train at --height x --width instead of --img-size square")
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--cache-ram", action="store_true")
    parser.add_argument("--cache", default=None, choices=["ram", "disk"])
    parser.add_argument("--max-labels", type=int, default=120,
                        help="fixed per-image label padding of the step")
    parser.add_argument("--seed", type=int, default=1,
                        help="seeds the weights' init, the shuffle and the augmentation")
    parser.add_argument("--log-interval", type=int, default=50)
    parser.add_argument("--img-floor", type=int, default=256,
                        help="minimum training image size (reference floors at 256)")
    parser.add_argument("--profile", action="store_true",
                        help="torch.profiler over steps 2-4 of the first epoch, to "
                             "<save_dir>/profile")
    parser.add_argument("--ckpt-backend", default="torch", choices=["torch", "orbax"])
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 autocast in the forward (the reference's AMP analog)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; cuda raises when there is no GPU")
    return parser


def check_and_init(args):
    """The save dir, resume with the run's saved args, the image size and the
    seeds; writes ``args.yaml`` (reference: tools/train.py:65-109). Returns
    the config. Across ranks rank 0 names and makes the directory and
    writes ``args.yaml``; every rank reads a resumed run's."""
    if args.resume:
        checkpoint_path = (args.resume if isinstance(args.resume, str)
                           else find_latest_checkpoint())
        if not checkpoint_path or not os.path.exists(checkpoint_path):
            raise FileNotFoundError(f"resume checkpoint {checkpoint_path!r} not found")
        save_dir = osp.dirname(osp.dirname(osp.normpath(checkpoint_path)))
        args_yaml = osp.join(save_dir, "args.yaml")
        if osp.exists(args_yaml):
            saved = load_yaml(args_yaml)
            saved.pop("resume", None)
            vars(args).update(saved)
        else:
            LOGGER.warning(f"no args.yaml found under {save_dir}; using the command line's")
        args.save_dir = save_dir
        args.resume = checkpoint_path
        LOGGER.info(f"Resume training from checkpoint {checkpoint_path}")
    else:
        args.save_dir = broadcast_object(
            str(increment_name(osp.join(args.output_dir, args.name))) if is_main_process()
            else None)

    cfg = Config.fromfile(args.conf_file)
    if "training_mode" not in cfg:
        cfg.training_mode = "repvgg"
    check_supported(args, cfg)
    if args.specific_shape:  # JAX tools/train.py:110-112
        if not (args.height and args.width):
            raise ValueError("--specific-shape needs --height and --width")
        args.height = check_img_size(args.height, 32, floor=args.img_floor)
        args.width = check_img_size(args.width, 32, floor=args.img_floor)
    else:
        args.img_size = check_img_size(args.img_size, 32, floor=args.img_floor)

    random.seed(args.seed)
    np.random.seed(args.seed)
    if is_main_process():
        os.makedirs(args.save_dir, exist_ok=True)
        save_yaml(vars(args), osp.join(args.save_dir, "args.yaml"))
    return cfg


def build_trainer(args):
    """Join the process group under torchrun (JAX tools/train.py:120-127; a
    group the caller initialised is used as it is), check the arguments and
    build the ``Trainer``."""
    initialize_distributed(args.device)
    return Trainer(args, check_and_init(args))


def run(trainer):
    """Train a built ``Trainer``, or with ``--quant --calib`` calibrate it
    instead (``Trainer.calibrate``, JAX tools/train.py:130-132); returns it."""
    if trainer.args.quant and trainer.args.calib:
        trainer.calib_path = trainer.calibrate()
        return trainer
    trainer.train()
    return trainer


def main(args):
    """Train; returns the ``Trainer`` (its ``epoch_stats``, ``eval_stats``
    and ``profile_result``)."""
    return run(build_trainer(args))

if __name__ == "__main__":
    main(get_args_parser().parse_args())
