"""Trainer: the training state machine (port of yolov6_tpu/core/engine.py).

The epoch loop, the eval cadence, checkpointing, the shut-off of the strong
augmentations in the last epochs and resume stay on the host; each batch
runs through ``core/train_step.py``'s step, which reads nothing back. The
loader collates into pinned memory, and the next batch's copy to the card is
queued while the step before it runs. The in-training eval runs the EMA
(train form, eval mode, as the JAX package evaluates it with
``train=False``) through the port's ``Evaler`` and so through the NMS kernel.

The training recipes of YOLOv6 v3.0 run through the same loop: ``fuse_ab``
(anchor-aided training: the fuse-AB head and ``ComputeLossAB`` beside the
anchor-free loss) and ``distill`` (self-distillation against the teacher at
``teacher_model_path``, a model of the same config, fuse-AB but for P6: the distill-NS
head and ``ComputeLossDistillNS`` for N and S, ``ComputeLossDistill`` for
M and L).

Fine-tuning: with ``cfg.model.pretrained`` set, the seeded train graph
takes every tensor of that file (the port's own checkpoint or an upstream
YOLOv6 ``.pt``, utils/checkpoint.py::read_state_dict) whose name and shape
match, as the JAX trainer does; a missing file raises, where the JAX
trainer tries a download, and so does a key the train graph lacks (other
than the recipes' train-only branches), which the JAX trainer skips.
RepOpt (``training_mode = "repopt"``): the hyper-search checkpoint at
``cfg.model.scales`` gives the CSLA scales, which re-initialise the RealVGG
convs (unless ``pretrained`` is set) and make the step's gradient masks
(solver/repoptimizer.py).

Quantisation (``--quant``, JAX: engine.py:134-166, :506-513, :581-584,
:684-708): with ``--calib``, ``calibrate()`` records the train graph's conv
input ranges over ``ptq.calib_batches`` train batches and writes them with
the fake-quantised weights as ``calib_ckpt.pt`` under
``ptq.calib_output_path`` (across ranks, the ranges' maximum over every
rank's batches); without it, QAT: the train graph takes the
tensors and ranges of ``qat.calib_pt`` (after any ``pretrained`` load), and
every step's forward, the in-training eval of the EMA and the checkpoints
(``model`` and ``ema``, each with a ``quant`` entry) carry the frozen
ranges. Both run with no warmup.

Data parallel (JAX: engine.py:56-62, 334-352, 540-640): under torchrun
(``tools/train.py`` joins the group, ``parallel/dist.py``) each rank loads
its shard of the train set at ``batch_size // world`` (padded by wrap-around,
as the JAX shards are) and steps with synchronised BatchNorm, global loss
normalisers and the summed gradient (``core/train_step.py``), so N ranks at
a global batch B take the step of one process at B. Every rank predicts its
shard of the val set with the keep kernel on its own device; the COCO rows
are gathered, rank 0 scores them and broadcasts ``(AP50, AP)``, so that the
best-checkpoint tracking agrees on every rank. Rank 0 alone logs at INFO,
writes the checkpoints, the profile and ``predictions.json``. ``--cache
ram|disk`` (``--cache-ram`` is ``ram``) keeps the train path's decoded,
pre-resized images (``data/datasets.py``).

TensorBoard (JAX: engine.py:270-277, :389-443, :524-536, :640-682): rank 0
writes an event file into the run's directory (``utils/tb_writer.py``;
``args.no_tensorboard`` turns it off) with, at the end of each epoch, the
val APs, the three mean losses and the three group LRs at step ``epoch +
1`` (``utils/events.py::write_tblog``); after each in-training eval up to 8
val images with their best predictions drawn (``val_img_*``); and with
``--write_trainbatch_tb`` at the first step of each epoch the annotated
train batch (``train_batch``, ``plot_train_batch``). The boxes are cv2's
``LINE_8`` rectangles pixel for pixel and the resize is cv2's INTER_LINEAR;
the text is the port's 5x7 font, not Hershey.

Not ported, and refused with ``NotImplementedError``: the orbax checkpoint
backend (queue 1, "Do not port").
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Optional

import numpy as np
import torch

from yolov6_tpu_torch.core.evaler import Evaler, gather_coco_predictions
from yolov6_tpu_torch.core.inferer import Inferer
from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.data.data_augment import resize_linear
from yolov6_tpu_torch.data.data_load import create_dataloader
from yolov6_tpu_torch.data.image_io import imread
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.losses.loss_distill import ComputeLossDistill
from yolov6_tpu_torch.losses.loss_distill_ns import ComputeLossDistillNS
from yolov6_tpu_torch.losses.loss_fuseab import ComputeLossAB
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.parallel.dist import (
    all_reduce_max_, broadcast_object, is_main_process, process_shard_info, rank_device,
    world_size,
)
from yolov6_tpu_torch.quant.ptq import calibrate, quantize_variables
from yolov6_tpu_torch.quant.state import quant_mode
from yolov6_tpu_torch.solver.build import group_lrs_host, scale_hyperparams_for_batch
from yolov6_tpu_torch.solver.repoptimizer import (
    extract_scales, generate_gradient_masks, reinitialize,
)
from yolov6_tpu_torch.utils.checkpoint import (
    cpu_copy, load_checkpoint, load_state_dict_partial, read_state_dict, save_checkpoint,
    strip_optimizer,
)
from yolov6_tpu_torch.utils.coco_eval import coco80_to_coco91_class
from yolov6_tpu_torch.utils.device import resolve_device
from yolov6_tpu_torch.utils.draw import put_text, rectangle_line8
from yolov6_tpu_torch.utils.events import LOGGER, load_yaml, write_tbimg, write_tblog
from yolov6_tpu_torch.utils.tb_writer import TBWriter


def check_supported(args, cfg) -> None:
    """Raise ``NotImplementedError`` for what the port's trainer does not do,
    and ``ValueError`` for a recipe that cannot be: fuse-AB and distillation
    together (as the JAX trainer), distillation without a teacher, or either
    recipe on a lite config (the lite family has neither head; the JAX
    package would train the plain lite network instead)."""
    recipes = [f"--{flag}" for flag in ("distill", "fuse_ab") if getattr(args, flag, False)]
    if recipes and cfg.model.backbone.type == "Lite_EffiBackbone":
        raise ValueError(f"{' and '.join(recipes)} on {cfg.model.type}: the lite family has no "
                         "fuse-AB or distillation recipe")
    if getattr(args, "distill", False):
        if getattr(args, "fuse_ab", False):
            raise ValueError("distill models should turn off fuse_ab: --distill trains "
                             "against a fuse-AB teacher, --fuse_ab trains one")
        if not getattr(args, "teacher_model_path", None):
            raise ValueError("--distill needs --teacher_model_path (the teacher's .pt)")
    if getattr(args, "ckpt_backend", "torch") != "torch":
        raise NotImplementedError(
            f"--ckpt-backend {args.ckpt_backend}: the port saves with torch.save only (orbax "
            "is on ROADMAP queue 1, \"Do not port\")")


def read_repopt_scales(cfg):
    """The state dict of the hyper-search checkpoint at ``cfg.model.scales``:
    the port's own (the EMA first) or an upstream one built in
    ``hyper_search`` mode (a RepOpt block the file has no scales for raises
    ``KeyError`` in the re-init and the masks). The configs' default
    ``assets/*_scale.msgpack`` is a JAX native file, which raises
    ``ValueError``, as does a file with no LinearAddBlock scales."""
    path = cfg.model.get("scales")
    if not path:
        raise ValueError("No scales provided to init RepOptimizer! (cfg.model.scales: the "
                         "hyper-search run's checkpoint)")
    if path.endswith(".msgpack"):
        raise ValueError(f"{path}: a JAX native msgpack file, which the port does not read; "
                         "cfg.model.scales takes the port's own checkpoint of a hyper-search "
                         "run (its weights/last_ckpt.pt) or an upstream YOLOv6 .pt built in "
                         "hyper_search mode")
    state = read_state_dict(path)
    if not any(k.endswith("scale_conv.weight") for k in state):
        raise ValueError(f"{path}: no LinearAddBlock scales; cfg.model.scales takes a "
                         "hyper-search run's checkpoint")
    return state


def read_qat_calibration(cfg):
    """QAT's calibration (JAX: engine.py:144-166): the state dict of
    ``cfg.qat.calib_pt`` (a ``--quant --calib`` run's ``calib_ckpt.pt``)
    and the step's ``quant``: its ranges, ``ptq.num_bits``, and
    ``qat.sensitive_layers_list`` as skips when ``qat.sensitive_layers_skip``.
    A missing ``calib_pt``, the configs' default JAX ``.msgpack`` file and a
    file without ranges raise ``ValueError``."""
    qat = cfg.get("qat") or {}
    path = qat.get("calib_pt")
    if not path:
        raise ValueError("QAT needs a calibrated checkpoint (cfg.qat.calib_pt)")
    if path.endswith(".msgpack"):
        raise ValueError(f"{path}: a JAX native msgpack file, which the port does not read; "
                         "cfg.qat.calib_pt takes the port's own calibration checkpoint, the "
                         "calib_ckpt.pt of tools/train.py --quant --calib (README, "
                         "\"Quantisation\")")
    state, amax = read_state_dict(path, with_quant=True)
    if amax is None:
        raise ValueError(f"{path}: no calibrated ranges (no 'quant' entry); cfg.qat.calib_pt "
                         "takes the calib_ckpt.pt of tools/train.py --quant --calib")
    skip = qat.get("sensitive_layers_list", []) if qat.get("sensitive_layers_skip") else []
    return state, dict(amax=amax, num_bits=(cfg.get("ptq") or {}).get("num_bits", 8),
                       skip_patterns=list(skip))


class Trainer:
    """Trains ``cfg``'s model on ``args.data_path`` (the arguments of
    ``tools/train.py``, its ``save_dir`` set by ``check_and_init``) on
    ``args.device``.

    After ``train()``: ``epoch_stats`` holds per epoch the steps, the wall
    time on the host clock, the time blocked on the loader and, on the card,
    the steps' time by CUDA events; ``eval_stats`` per in-training eval its
    images and wall time; ``profile_result``, with ``args.profile``, the
    device's busy and idle share over a window of steps of the first epoch."""

    def __init__(self, args, cfg):
        check_supported(args, cfg)
        self.args = args
        self.cfg = cfg
        self.device = rank_device(resolve_device(getattr(args, "device", "cuda")))
        self.main_process = is_main_process()
        self.world = world_size()
        if args.batch_size % self.world:
            raise ValueError(f"--batch-size {args.batch_size} (the global batch) does not "
                             f"split over {self.world} ranks")
        self.max_epoch = args.epochs
        self.save_dir = args.save_dir
        self.data_dict = load_yaml(args.data_path)
        self.num_classes = self.data_dict["nc"]
        if self.data_dict.get("is_coco"):
            self.ids_to_contig = {c: i for i, c in enumerate(coco80_to_coco91_class())}
        else:
            self.ids_to_contig = {i: i for i in range(self.num_classes)}
        self.img_size = args.img_size
        # the train batches' (h, w): --specific-shape trains at --height x
        # --width (the JAX trainer builds its step at (img_size, img_size)
        # whatever the shape, which does not fit a non-square batch)
        self.train_hw = ((args.height, args.width) if getattr(args, "specific_shape", False)
                         else (args.img_size, args.img_size))
        self.batch_size = args.batch_size

        self.fuse_ab = bool(getattr(args, "fuse_ab", False))
        self.distill = bool(getattr(args, "distill", False))
        self.distill_ns = self.distill and cfg.model.type in ("YOLOv6n", "YOLOv6s")

        # the weights' init: torch's (kaiming uniform, a=sqrt(5)), the
        # distribution of the JAX package's conv_kernel_init, from the seed
        torch.manual_seed(args.seed)
        self.model = build_model(cfg, self.num_classes, deploy=False, device=self.device,
                                 fuse_ab=self.fuse_ab, distill_ns=self.distill_ns)
        pretrained = cfg.model.get("pretrained")
        self.pretrained_matched = None
        if pretrained:
            # JAX: engine.py:80-103 (which tries a download for a missing file)
            LOGGER.info(f"Loading state_dict from {pretrained} for fine-tuning...")
            self.pretrained_matched = load_state_dict_partial(read_state_dict(pretrained),
                                                              self.model)
        self.teacher = self.load_teacher(args.teacher_model_path) if self.distill else None

        self.train_loader, self.val_loader = self.get_data_loader(args, cfg, self.data_dict)
        self.max_stepnum = len(self.train_loader)

        self.solver_cfg = scale_hyperparams_for_batch(
            dict(cfg.solver), self.batch_size,
            world_batch=args.bs_per_device and args.bs_per_device * self.world)
        self.solver_cfg.setdefault("lr_scheduler", cfg.solver.get("lr_scheduler", "Cosine"))
        quant = bool(getattr(args, "quant", False))
        self.warmup_stepnum = (0 if quant else
                               max(round(self.solver_cfg["warmup_epochs"] * self.max_stepnum),
                                   1000))
        self.quant = None
        if quant and not getattr(args, "calib", False):
            # QAT: the calibration's tensors replace any pretrained load
            state, self.quant = read_qat_calibration(cfg)
            self.model.load_state_dict(state, strict=True)
            LOGGER.info(f"QAT from {cfg.qat.calib_pt}: {len(self.quant['amax'])} ranges")

        grad_masks = None
        if cfg.get("training_mode") == "repopt":
            # JAX: engine.py:168-198: the scales, the re-init unless fine-tuning, the masks
            self.repopt_scales = extract_scales(read_repopt_scales(cfg))
            if not pretrained:
                reinitialize(self.model, self.repopt_scales)
            grad_masks = generate_gradient_masks(self.model, self.repopt_scales)

        self.atss_warmup_epoch = cfg.model.head.get("atss_warmup_epoch", 4)
        self.compute_loss, self.compute_loss_ab, self.distill_loss = self._build_losses(cfg)
        self.train_step = make_train_step(
            self.model, self.compute_loss, self.solver_cfg, self.max_stepnum, self.max_epoch,
            self.batch_size, self.warmup_stepnum, self.train_hw,
            half=bool(args.bf16), device=self.device, compute_loss_ab=self.compute_loss_ab,
            teacher=None if self.teacher is None else (self.teacher, self.distill_loss),
            grad_masks=grad_masks, quant=self.quant)

        self.start_epoch = 0
        self.best_ap = 0.0
        self.best_stop_strong_aug_ap = 0.0
        self.evaluate_results = (0.0, 0.0)
        if args.resume:
            ckpt = load_checkpoint(args.resume)
            if "train_state" not in ckpt:
                raise ValueError(f"{args.resume} holds no train state (a finished run's "
                                 "last_ckpt.pt is stripped to the EMA); resume from an "
                                 "<epoch>_ckpt.pt or an unfinished run's last_ckpt.pt")
            self.train_step.load_state_dict(ckpt["train_state"])
            self.start_epoch = int(ckpt["epoch"]) + 1
            self.evaluate_results = tuple(float(v) for v in ckpt.get("results", (0.0, 0.0)))
            self.best_ap = self.evaluate_results[1]
            self.best_stop_strong_aug_ap = self.evaluate_results[1]
            if self.start_epoch > self.max_epoch - args.stop_aug_last_n_epoch:
                self._stop_strong_aug()

        self.epoch_stats, self.eval_stats = [], []
        self.profile_result: Optional[dict] = None
        self.tblogger = None
        if self.main_process and not getattr(args, "no_tensorboard", False):
            self.tblogger = TBWriter(self.save_dir)

    def calibrate(self) -> str:
        """``--quant --calib`` (JAX: engine.py:684-708): the train graph's
        conv input ranges over ``ptq.calib_batches`` batches of the train
        loader (in eval mode, skipping ``ptq.sensitive_layers_list`` when
        ``ptq.sensitive_layers_skip``), then every conv weight fake-quantised
        (no skip, as in JAX), saved as ``{"model": state dict + "quant"}`` to
        ``calib_ckpt.pt`` under ``ptq.calib_output_path`` (else the run's
        ``weights/``). Returns the file's path."""
        ptq = self.cfg.get("ptq") or {}
        num_bits = ptq.get("num_bits", 8)
        skip = ptq.get("sensitive_layers_list", []) if ptq.get("sensitive_layers_skip") else []
        amax = calibrate(self.model, (batch[0] for batch in self.train_loader),
                         num_bits=num_bits, skip_patterns=skip,
                         max_batches=ptq.get("calib_batches", 32))
        amax = {k: all_reduce_max_(v) for k, v in amax.items()}  # over every rank's batches
        state = quantize_variables(self.model.state_dict(), self.model, num_bits)
        out_dir = ptq.get("calib_output_path", osp.join(self.save_dir, "weights"))
        path = osp.join(out_dir, "calib_ckpt.pt")
        if self.main_process:
            path = save_checkpoint({"model": dict(cpu_copy(state), quant=cpu_copy(amax))},
                                   False, out_dir, "calib_ckpt")
            LOGGER.info(f"calibrated checkpoint saved to {path}")
        return path

    def _build_losses(self, cfg):
        """The anchor-free loss, and the recipe's loss or ``None``: the AB
        loss with ``fuse_ab``, the distillation loss with ``distill`` (JAX:
        engine.py:288-323)."""
        head = cfg.model.head
        common = dict(fpn_strides=tuple(head.strides), num_classes=self.num_classes,
                      ori_img_size=self.img_size, iou_type=head.iou_type)
        loss = ComputeLoss(warmup_epoch=self.atss_warmup_epoch, use_dfl=head.use_dfl,
                           reg_max=head.reg_max, **common)
        loss_ab = distill = None
        if self.fuse_ab:
            loss_ab = ComputeLossAB(anchors_init=tuple(map(tuple, head.anchors_init)), **common)
        if self.distill:
            loss_cls = ComputeLossDistillNS if self.distill_ns else ComputeLossDistill
            distill = loss_cls(
                warmup_epoch=self.atss_warmup_epoch, use_dfl=head.use_dfl, reg_max=head.reg_max,
                distill_weight=dict(head.distill_weight), distill_feat=self.args.distill_feat,
                max_epoch=self.max_epoch, temperature=self.args.temperature, **common)
        return loss, loss_ab, distill

    def load_teacher(self, path: str):
        """The distillation teacher: the config's train graph, with the fuse-AB
        head for a 3-level head and the plain head for a P6 one, which has no
        anchors to aid it (JAX: engine.py:110), on the device in eval mode,
        its weights from the checkpoint at ``path``: the port's own (the EMA,
        else the model) or an upstream ``.pt`` (``read_state_dict``). Only
        the anchor-based branch may be missing from it, as the JAX partial
        load allows (a teacher trained without ``--fuse_ab``); any other
        missing or unexpected key, or a tensor of another shape, raises."""
        state = read_state_dict(path)
        fuse_ab = self.cfg.model.head.num_layers == 3
        teacher = build_model(self.cfg, self.num_classes, deploy=False, device=self.device,
                              fuse_ab=fuse_ab)
        own = teacher.state_dict()
        missing = [k for k in own if k not in state]
        bad = [k for k in missing if not k.startswith(("detect.cls_preds_ab.",
                                                       "detect.reg_preds_ab."))]
        unexpected = [k for k in state if k not in own]
        reshaped = [k for k in own if k in state and state[k].shape != own[k].shape]
        if bad or unexpected or reshaped:
            head = "the fuse-AB head" if fuse_ab else "the plain head"
            raise ValueError(f"{path} does not fit the teacher ({self.cfg.model.type} with "
                             f"{head}): missing {bad}, unexpected {unexpected}, other shapes "
                             f"{reshaped}")
        teacher.load_state_dict(state, strict=False)
        LOGGER.info(f"Loaded the teacher from {path}"
                    + (f" (no anchor-based branch: {len(missing)} keys left at init)"
                       if missing else ""))
        return teacher.eval().requires_grad_(False)

    def get_data_loader(self, args, cfg, data_dict):
        """The augmenting, shuffled train loader and the val loader of this
        rank's shard, each at ``batch_size // world`` (JAX: engine.py:334-352).
        The train loader takes the shape and check flags; the val loader
        stays square at ``img_size``, as in JAX. The train shards are padded
        by wrap-around to one length, so every rank takes the same steps;
        the val shards are not, so that no detection is counted twice."""
        pin = self.device.type == "cuda"
        shard_id, num_shards = process_shard_info()
        cache = getattr(args, "cache", None) or ("ram" if getattr(args, "cache_ram", False)
                                                 else None)
        if cache == "ram" and num_shards > 1 and self.main_process:
            LOGGER.warning("--cache ram keeps a copy a rank of every image its mosaic and mixup "
                           "draw, up to the whole train set a rank (world x the set on the "
                           "host); --cache disk keeps one copy that the ranks share")
        train_loader, _ = create_dataloader(
            data_dict["train"], args.img_size, self.batch_size // num_shards,
            hyp=dict(cfg.data_aug), augment=True, data_dict=data_dict, task="train",
            num_workers=args.workers, max_labels=args.max_labels, pin_memory=pin,
            seed=args.seed, shard_id=shard_id, num_shards=num_shards, cache=cache,
            check_images=getattr(args, "check_images", False),
            check_labels=getattr(args, "check_labels", False),
            specific_shape=getattr(args, "specific_shape", False),
            height=getattr(args, "height", None), width=getattr(args, "width", None))
        val_loader, _ = create_dataloader(
            data_dict["val"], args.img_size, self.batch_size // num_shards, hyp={},
            data_dict=data_dict, task="val", num_workers=args.workers, pin_memory=pin,
            shard_id=shard_id, num_shards=num_shards, pad_shards=False)
        return train_loader, val_loader

    def _stop_strong_aug(self) -> None:
        self.cfg.data_aug.mosaic = 0.0
        self.cfg.data_aug.mixup = 0.0

    # ---------------------------------------------------------------- train

    def train(self) -> None:
        LOGGER.info("Training start...")
        self.start_time = time.time()
        # the last completed epoch, valid when a resumed run has nothing left
        self.epoch = self.start_epoch - 1
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            self.train_one_epoch(self.epoch)
            self.after_epoch()
        self.strip_model()
        if self.tblogger is not None:
            self.tblogger.close()

    def before_epoch(self) -> None:
        """The strong-augmentation shut-off (reference: engine.py:324-330)."""
        if self.epoch == self.max_epoch - self.args.stop_aug_last_n_epoch:
            self._stop_strong_aug()
            self.train_loader, self.val_loader = self.get_data_loader(
                self.args, self.cfg, self.data_dict)
        self.train_loader.set_epoch(self.epoch)
        self.mean_loss = None

    def plot_train_batch(self, imgs, labels, paths, max_size=1920, max_subplots=16):
        """The first ``max_subplots`` images of a host batch (uint8 NHWC RGB)
        tiled column-major in a square grid, each with a white 2-px border,
        its file name and its labels' boxes and class names, scaled down to
        ``max_size`` (JAX: engine.py:389-425); returns HWC RGB."""
        imgs = imgs.numpy() if torch.is_tensor(imgs) else np.asarray(imgs)
        bs, h, w, _ = imgs.shape
        bs = min(bs, max_subplots)
        ns = int(np.ceil(bs ** 0.5))
        mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
        for i in range(bs):
            x0, y0 = w * (i // ns), h * (i % ns)
            mosaic[y0:y0 + h, x0:x0 + w] = imgs[i][..., ::-1]  # drawn in BGR, as cv2 draws
            rectangle_line8(mosaic, (x0, y0), (x0 + w, y0 + h), (255, 255, 255), 2)
            put_text(mosaic, osp.basename(paths[i])[:40], (x0 + 5, y0 + 15), 0.5,
                     (220, 220, 220), 1)
            lb = labels[i]
            lb = lb[lb[:, 0] >= 0]
            for cls, cx, cy, bw, bh in lb:
                x1 = int((cx - bw / 2) * w) + x0
                y1 = int((cy - bh / 2) * h) + y0
                x2 = int((cx + bw / 2) * w) + x0
                y2 = int((cy + bh / 2) * h) + y0
                color = tuple(int(c) for c in np.random.default_rng(int(cls)).integers(64, 255, 3))
                rectangle_line8(mosaic, (x1, y1), (x2, y2), color, 1)
                put_text(mosaic, str(self.data_dict["names"][int(cls)]), (x1, max(y1 - 5, 10)),
                         0.5, color, 1)
        scale = max_size / ns / max(h, w)
        if scale < 1:
            mosaic = resize_linear(mosaic, (int(ns * w * scale), int(ns * h * scale)))
        return mosaic[..., ::-1]

    def _to_device(self, batch):
        """A host batch's images and labels, their copy to the device queued."""
        if batch is None:
            return None
        imgs, labels = batch[0], batch[1]
        imgs = imgs if torch.is_tensor(imgs) else torch.from_numpy(imgs)
        return (imgs.to(self.device, non_blocking=True),
                torch.from_numpy(labels).to(self.device, non_blocking=True))

    def train_one_epoch(self, epoch_num: int) -> None:
        use_atss = epoch_num < self.atss_warmup_epoch
        epoch = torch.full((), float(epoch_num), device=self.device)
        cuda = self.device.type == "cuda"
        log_interval = self.args.log_interval
        profile_at = (range(2, 5) if getattr(self.args, "profile", False)
                      and epoch_num == self.start_epoch and self.main_process else range(0))
        prof = None
        events, wait_s, mean = [], 0.0, None
        t_epoch = time.perf_counter()
        batches = iter(self.train_loader)
        t0 = time.perf_counter()
        host = next(batches, None)
        cur = self._to_device(host)
        wait_s += time.perf_counter() - t0
        step = 0
        while cur is not None:
            if step == 0 and self.tblogger is not None and getattr(
                    self.args, "write_trainbatch_tb", False):
                mosaic = self.plot_train_batch(host[0], host[1], host[2])
                write_tbimg(self.tblogger, mosaic, step + self.max_stepnum * epoch_num,
                            type="train")
                self.tblogger.flush()
            if step == profile_at.start and len(profile_at):
                prof = self._start_profile()
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            _, components = self.train_step(cur[0], cur[1], epoch, use_atss=use_atss)
            if cuda:
                ev[1].record()
                events.append(ev)
            # the running mean stays on the device; the host reads it only
            # to log
            mean = components if mean is None else (mean * step + components) / (step + 1)
            if step % log_interval == 0:
                self.mean_loss = mean.cpu().numpy()
                LOGGER.info(f"epoch {epoch_num}/{self.max_epoch - 1} step {step}/"
                            f"{self.max_stepnum} iou/dfl/cls{'/cwd' * self.distill}: "
                            + "/".join(f"{v:.4g}" for v in self.mean_loss))
            if prof is not None and step == profile_at.stop - 1:
                self._stop_profile(prof, len(profile_at))
                prof = None
            # the next batch: the host waits on the loader while the device
            # runs this step, then queues the copy
            t0 = time.perf_counter()
            host = next(batches, None)
            cur = self._to_device(host)
            wait_s += time.perf_counter() - t0
            step += 1
        if prof is not None:
            self._stop_profile(prof, step - profile_at.start)
        if cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t_epoch
        if mean is not None:
            self.mean_loss = mean.cpu().numpy()
        self.epoch_stats.append(dict(
            epoch=epoch_num, steps=step, images=step * self.batch_size, wall_s=wall,
            imgs_per_s=step * self.batch_size / wall if wall > 0 else None,
            loader_wait_s=wait_s,
            step_ms=(sum(a.elapsed_time(b) for a, b in events) / len(events)
                     if events else None),
            mean_loss=None if self.mean_loss is None else [float(v) for v in self.mean_loss]))

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        prof = profile(activities=activities)
        prof.__enter__()
        prof.t0 = time.perf_counter()
        return prof

    def _stop_profile(self, prof, steps: int) -> None:
        """Close the profiler window: the device's busy time by kernel and its
        idle share of the window's host wall time; the trace goes to
        ``<save_dir>/profile``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - prof.t0
        prof.__exit__(None, None, None)
        os.makedirs(osp.join(self.save_dir, "profile"), exist_ok=True)
        prof.export_chrome_trace(osp.join(self.save_dir, "profile", "train_steps.json"))
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        self.profile_result = dict(
            steps=steps, wall_s=wall, device_busy_s=busy if kernels else None,
            idle=1.0 - busy / wall if kernels else None,
            top=[(e.key[:60], e.self_device_time_total / 1e3 / steps)
                 for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]])

    def after_epoch(self) -> None:
        """The eval cadence and the checkpoints (reference: engine.py:178-220)."""
        remaining_epochs = self.max_epoch - 1 - self.epoch
        eval_interval = (self.args.eval_interval if remaining_epochs >= self.args.heavy_eval_range
                         else min(3, self.args.eval_interval))
        is_val_epoch = (remaining_epochs == 0) or (
            not self.args.eval_final_only and (self.epoch + 1) % eval_interval == 0)
        self.ap = self.evaluate_results[1]
        if is_val_epoch:
            self.eval_model()
            self.ap = self.evaluate_results[1]
            self.best_ap = max(self.ap, self.best_ap)
        if not self.main_process:  # rank 0 writes the checkpoints
            return

        ckpt = {
            "train_state": self.train_step.state_dict(),
            "model": cpu_copy(self.train_step.model.state_dict()),
            "ema": cpu_copy(self.train_step.ema.state_dict()),
            "epoch": self.epoch,
            "results": [float(v) for v in self.evaluate_results],
        }
        if self.quant is not None:
            # the frozen ranges, so that a QAT checkpoint deploys on its own
            ckpt["model"]["quant"] = cpu_copy(self.quant["amax"])
            ckpt["ema"]["quant"] = cpu_copy(self.quant["amax"])
        save_ckpt_dir = osp.join(self.save_dir, "weights")
        save_checkpoint(ckpt, is_val_epoch and self.ap == self.best_ap, save_ckpt_dir,
                        "last_ckpt")
        if self.epoch >= self.max_epoch - self.args.save_ckpt_on_last_n_epoch:
            save_checkpoint(ckpt, False, save_ckpt_dir, f"{self.epoch}_ckpt")
        if self.epoch >= self.max_epoch - self.args.stop_aug_last_n_epoch:
            if self.best_stop_strong_aug_ap < self.ap:
                self.best_stop_strong_aug_ap = max(self.ap, self.best_stop_strong_aug_ap)
                save_checkpoint(ckpt, False, save_ckpt_dir, "best_stop_aug_ckpt")
        if self.tblogger is not None and self.mean_loss is not None:
            self.log_epoch_scalars()

    def log_epoch_scalars(self) -> None:
        """The epoch's TensorBoard scalars: the APs, the mean losses and the
        group LRs at the epoch's last step (JAX: engine.py:524-536)."""
        lrs = group_lrs_host((self.epoch + 1) * self.max_stepnum, float(self.epoch),
                             self.warmup_stepnum, self.solver_cfg, self.max_epoch)
        write_tblog(self.tblogger, self.epoch, self.evaluate_results, list(lrs),
                    list(self.mean_loss[:3]))
        self.tblogger.flush()

    def eval_model(self) -> None:
        """In-training eval of the EMA (reference: engine.py:222-269); the
        config's ``eval_params`` override the defaults (reference :236-264).
        Across ranks each rank predicts its val shard, the rows are gathered
        (``predictions`` holds them on every rank), rank 0 scores them and
        the APs are broadcast (JAX: engine.py:594-640)."""
        ep = self.cfg.get("eval_params") or {}

        def val(key, default):
            v = ep.get(key)
            if isinstance(v, list):
                v = v[0]
            return default if v is None else v

        evaler = Evaler(
            self.data_dict, batch_size=val("batch_size", self.batch_size) // self.world,
            img_size=val("img_size", self.img_size), conf_thres=val("conf_thres", 0.03),
            iou_thres=val("iou_thres", 0.65),
            save_dir=self.save_dir if self.main_process else "",
            shrink_size=val("shrink_size", 0) or 0, verbose=val("verbose", False),
            do_coco_metric=val("do_coco_metric", True), do_pr_metric=val("do_pr_metric", False),
            device=self.device)
        model = self.train_step.ema
        evaler.init_model(model)
        t0 = time.perf_counter()
        # QAT: the EMA evaluates with its convs' inputs fake-quantised
        with quant_mode(model, **(self.quant or {})):
            preds = evaler.predict_model(model, self.val_loader, task="train")
        predict_s = time.perf_counter() - t0
        preds = gather_coco_predictions(preds, self.val_loader.dataset.img_paths)
        results = (evaler.eval_model(preds, model, self.val_loader, task="train")[:2]
                   if self.main_process else None)
        results = broadcast_object(results)  # rank 0's APs on every rank
        self.predictions = preds
        LOGGER.info(f"Epoch: {self.epoch} | mAP@0.5: {results[0]} | mAP@0.50:0.95: {results[1]}")
        self.evaluate_results = tuple(float(v) for v in results[:2])
        if self.tblogger is not None:
            self._plot_val_pred(preds)
        n_img = int(evaler.speed_result[0])
        self.eval_stats.append(dict(epoch=self.epoch, images=n_img, batches=len(evaler.batch_split),
                                    predict_s=predict_s, imgs_per_s=n_img / predict_s,
                                    ap50=self.evaluate_results[0], ap=self.evaluate_results[1]))

    def _plot_val_pred(self, pred_results, vis_conf=0.3, vis_max_box_num=5, max_imgs=8):
        """The first ``max_imgs`` val images with a prediction, each with its
        ``vis_max_box_num`` best rows of score ``vis_conf`` or more drawn, to
        TensorBoard as ``val_img_*`` (JAX: engine.py:640-682)."""
        by_image = {}
        for d in pred_results:
            by_image.setdefault(d["image_id"], []).append(d)
        stem_to_path = {}
        for p in self.val_loader.dataset.img_paths:
            stem = osp.splitext(osp.basename(p))[0]
            stem_to_path[int(stem) if stem.isnumeric() else stem] = p
        vis = []
        for image_id, dets in list(by_image.items())[:max_imgs]:
            path = stem_to_path.get(image_id)
            if path is None:
                continue
            img = imread(path)
            dets = sorted(dets, key=lambda d: -d["score"])[:vis_max_box_num]
            for d in dets:
                if d["score"] < vis_conf:
                    continue
                x, y, w, h = d["bbox"]
                cls_id = self.ids_to_contig.get(d["category_id"], 0)
                color = Inferer.generate_colors(cls_id, True)
                rectangle_line8(img, (int(x), int(y)), (int(x + w), int(y + h)), color, 1)
                put_text(img, f"{self.data_dict['names'][cls_id]}: {d['score']:.2f}",
                         (int(x), max(int(y) - 8, 10)), 0.5, color, 1)
            vis.append(img[:, :, ::-1])
        if vis:
            write_tbimg(self.tblogger, vis, self.epoch, type="val")
            self.tblogger.flush()

    def strip_model(self) -> None:
        LOGGER.info(f"\nTraining completed in {(time.time() - self.start_time) / 3600:.3f} hours.")
        if self.main_process:
            strip_optimizer(osp.join(self.save_dir, "weights"), self.epoch)
