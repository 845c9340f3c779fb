#!/usr/bin/env python3
"""Drive the PyTorch port (yolov6_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root, one CUDA device

Phases, each of which asserts:
  1. the card, the versions, and the build of every CUDA kernel from csrc/;
  2. each kernel against its plain torch version on the card, at the NMS
     shapes of the serving and eval paths (equal outputs required): the keep
     on sorted candidates (the tile walk) and on unsorted ones (the argmax
     loop), under both rules; timed on the sorted ones, the main path's;
  3. the serving path at full width: YOLOv6-S (configs/yolov6s.py, 80
     classes, deploy) serving 32 uint8 images of 640x640 in fp32 through
     ``make_end2end_fn``; the NMS kernel must be launched, take the tile walk
     in every image (at the serving setting and at the eval protocol) and find
     detections; the default keep must equal the plain emit-once keep and
     ``'pallas'`` the plain loop on the same predictions, and the CPU decode
     of two of the images must agree with the CUDA decode;
  4. times of the bf16 serving function, with CUDA events;
  5. a torch.profiler trace of the bf16 serving function: kernel time by
     name and the device's idle share;
  6. the training step at full width: YOLOv6-S in its train form (BN,
     RepVGG's three branches), 80 classes, b32@640 in bf16 with the bench's
     data and solver (accumulation branch, warmup 10 steps); 3 warm-up
     steps, 20 timed with CUDA events, one more split into forward, loss
     (with the assignment), backward and optimizer+EMA, peak memory, the
     losses, the applied and held steps, and a torch.profiler window over 3
     steps; every loss must be finite and both kinds of step must occur;
  7. the fold: the trained model and its EMA folded into the deploy graph
     (``fold_to_deploy``, loaded with strict=True), whose fp32 forward must
     equal the train model's eval-mode forward; then the folded model serves
     b32@640 through ``make_end2end_fn``, and the NMS kernel must take the
     tile walk in every image;
  8. YOLOv6-M (configs/yolov6m.py: CSPBepBackbone, CSPRepBiFPANNeck, the DFL
     head) served as S is in phases 3-5: fp32 with the same checks, the
     kernel on M's own candidates against its plain version, bf16 times and
     a profile;
  9. M's training step as S's in phase 6 (BottleRep alphas, DFL on the TAL
     branch), then 3 steps on the ATSS branch, then the fold and the folded
     serve of phase 7;
 10. YOLOv6-L (configs/yolov6l.py, ``conv_silu`` blocks): the deploy graph
     serves b32@640 in bf16 through the kernel (timed), and the train form
     takes 3 + 5 steps in bf16 with DFL;
 11. COCO evaluation: the port's generator writes a synthetic val set of 160
     PNG images of mixed sizes (80 class names); a mock detector that emits
     the letterboxed GT boxes must score AP50 > 0.99 and AP > 0.95 through
     the port's loader, Evaler and evaluator; then the Evaler runs S and M
     (the deploy models of phases 3 and 8) at b32@640 in bf16 at the eval
     protocol, and S again with ``infer_on_rect``: one kernel launch per
     batch, the tile walk in every image of every batch, the kernel's keep
     equal to the plain emit-once keep on the counted run's first batch
     with a candidate (its inputs recorded as it ran), COCO
     rows found and AP finite in [0, 1]; it logs imgs/s, the per-batch split
     (loader wait, the host's time to queue the batch function, copy, host
     conversion; also over batches built beforehand, with no loader thread
     running), the COCO scoring time, ``measure_speed``, and the device's
     time and idle share from a profiled second pass;
 12. the train CLI: a 160-image PNG train split beside phase 11's val set
     (the same sizes, another seed); ``tools/train.py::main`` trains
     YOLOv6-S (80 classes, the config's data_aug: mosaic 1.0, mixup 0.0)
     b32@640 in bf16 for 2 epochs, epoch 0 on the mosaic branch and epoch 1
     on the letterbox+affine branch, with one in-training eval of the 160
     val images (at conf 0 through the config's eval_params, so that the
     barely trained model gives the kernel candidates), then resumes from
     the epoch-1 checkpoint for a third epoch: every loss finite, the
     checkpoints written, the resumed step's state equal to the saved one
     and its first epoch 2, one kernel launch per eval batch with the tile
     walk in every image, each run's first eval batch with a candidate kept
     as the plain emit-once keep keeps it, and the stripped final
     checkpoint loaded into the deploy graph (strict) through the fold; it
     logs imgs/s per epoch with the loader, the loader wait and the step's
     time (CUDA events) a step, the augmentation's host ms an image (the C++
     pass, the HSV pass), the device's idle share over 3 profiled steps of
     epoch 0, and the in-training eval's imgs/s;
 13. the learning gate (``tools/learning_gate.py`` at its defaults: YOLOv6-N,
     160 px, 256 train and 64 val images, 4 classes, 30 epochs, batch 16,
     seed 0, the exact-NMS pass on): final mAP50 > 0.75 and a gain > 0.20,
     the tile walk in every image of its evals, and the first batch with a
     candidate of its in-training eval, of its checkpoint evals and of its
     exact-NMS pass each kept as the plain emit-once keep keeps it; it logs
     the trajectory, the exact-NMS delta and the wall time;
 14. the fuse-AB (anchor-aided) training step: YOLOv6-S with the fuse-AB head,
     ``ComputeLossAB`` beside the anchor-free loss, on phase 6's cell; timed
     as phase 6 with the loss split into its anchor-free and anchor-based
     parts; then the fold (the anchor-based branch dropped) and the folded
     serve at conf 0.001, its first keep held against the plain emit-once
     keep;
 15. the distill-NS step: the DFL-switched S config, a fuse-AB S teacher
     (train form in eval mode, weights from a seed) and the distill-NS
     student, ``ComputeLossDistillNS`` with the channel-wise KD at
     temperature 20, epoch 100 of 300; timed as phase 14 with the teacher's
     forward its own part; the student folded with the original S config
     (the DFL branch dropped) and served as in phase 14;
 16. the M KD step: YOLOv6-M with a fuse-AB M teacher, ``ComputeLossDistill``
     with DFL and the channel-wise KD, 5 timed steps;
 17. the distill learning gate (``tools/learning_gate.py --distill`` at its
     defaults but ``--teacher-epochs 10``: the fuse-AB N teacher 10 epochs,
     then the distill-NS N student 30, 160 px, fp32): the student's final
     mAP50 > 0.75 and a gain > 0.20, the tile
     walk in every image of its evals, and the first keep with a candidate of
     the teacher's in-training eval, the student's, its checkpoint evals and
     its exact-NMS pass each held against the plain emit-once keep; it logs
     the teacher's final mAP50, the trajectory and the wall time;
 18. the P6 family at 1280 (configs/yolov6{n6,s6,m6,l6}.py, four levels,
     strides 8-64): each deploy graph serves 32 random uint8 images of
     1280x1280 in bf16 at the serving defaults, whose 34,000 anchors an
     image are capped at K = 30,000 NMS candidates; fwd+decode and serve
     timed (10 calls after 3), the first keep held against the plain
     emit-once keep and the kernel timed on those candidates beside its
     plain version and its bound; N6's CPU decode of two images held against
     the CUDA one in fp32 (TF32 off); L6's serve profiled (3 calls);
 19. P6 training at 1280: S6 (TAL, no DFL) at b32 and L6 (DFL, conv_silu) at
     the largest of b32/b16/b8 whose peak, predicted from a probe at b8,
     leaves 10% of the card free (the measured peak must too), each as phase
     9 trains M (10 timed steps, the split, peak memory, then 3 ATSS steps),
     then folded and served b32@1280 as in phase 7;
 20. L6 through the Evaler at its repro protocol (1280, shrink 41, conf
     0.03, IoU 0.65, multi-label, max_det 300) over phase 11's 160 PNG
     images, with phase 11's checks and numbers;
 21. the MBLA stage (configs/mbla/): X-MBLA's deploy graph serves b32@640
     as in phase 18; S-MBLA's training step at b32@640 (DFL, TAL) as phase 6
     (20 timed steps), then folded and served as in phase 7;
 22. N6 through the train CLI at 1280, batch 8, 2 epochs (both on the ATSS
     branch) over the first 64 images of phase 12's split, with one
     in-training eval of the 160 val images at conf 0: its first keep with a
     candidate held against the plain emit-once keep; imgs/s an epoch,
     loader wait and step time a step;
 23. inference: the repository's demo JPEGs (data/images) decode to the
     sha256 of cv2.imread's pixels (host decode timed); the infer CLI
     (``tools/infer.py::run``, in-process) runs full-width S with seeded
     weights over data/images at its defaults (conf 0.4, IoU 0.45, max_det
     1000, max_nms 2000: K = 2000 candidates an image), in fp32 and with
     ``--half``, then with ``--classes 0 2`` and ``--agnostic-nms``: one
     kernel launch an image, each keep equal to the plain emit-once keep, a
     PNG at the source's size and a label row a detection; a second run in
     each precision times the loop's steps (decode, letterbox, device, draw,
     write) and its imgs/s; the kernel is timed on the first image's
     candidates beside its plain version and bound; then the infer CLI with
     phase 13's trained N on the gate's 64 val images at 160 px must find
     most GT boxes (a detection of their class at IoU >= 0.5).
 24. the lite family at 320 (configs/yolov6_lite/yolov6_lite_{s,m,l}.py, four
     levels, strides 8-64, one anchor a cell): each deploy graph serves 32
     random uint8 images of 320x320 in bf16 at the serving defaults, K = 2,125
     candidates an image (every anchor), as phase 18 serves P6 (the first
     keep against the plain emit-once keep, fwd+decode and serve timed, the
     kernel on those candidates beside its plain version and bound), then
     the B=1 serve latency; Lite-S's CPU decode of two images held against
     the CUDA one, and one profile of its serve: kernels by name, launches
     a call, the device's idle share (launch gaps);
 25. Lite-S's training step at b32@320 (TAL, SIoU, no DFL), 20 timed steps,
     the split and peak memory, 3 ATSS steps, then folded (DPBlock's biased
     convs with their BNs) and served at conf 0.001 as in phase 7;
 26. Lite-S through the Evaler at 320 over phase 11's 160 PNG images at the
     eval protocol, with phase 11's checks and numbers;
 27. Lite-S through the train CLI at 320, batch 32, 2 epochs (both on ATSS)
     over phase 22's 64 train images, with one in-training eval at conf 0 (its
     first keep with a candidate held against the plain keep); then the
     infer CLI at ``--img-size 320`` over data/images with Lite-S's seeded
     serve weights (K = 2000, every keep equal to the plain keep) and
     ``hub.yolov6lite_s`` + ``hub.predict(..., img_size=320)`` on a demo JPEG
     (K = 2,125), with those weights and with the hub's own seed;
 28. the QARepVGG configs (configs/qarepvgg/): S-QA's step at b32@640 (20
     timed) and M-QA's (10 timed) as phase 6, each folded (the QARepVGG
     branches, the average and identity kernels and the post-sum BN into one
     conv) and served at conf 0.001 as in phase 7;
 29. the concat PAN necks (configs/experiment/): yolov6t (RepPANNeck) and
     yolov6s_csp_scaled (CSPRepPANNeck) serve b32@640 in bf16 as phase 18
     serves P6 (the first keep against the plain keep, times, the kernel on
     the served candidates); yolov6t takes 3 timed steps on phase 6's cell
     (SIoU), then is folded and served as in phase 7;
 30. RepOpt S at full width (configs/repopt/yolov6s_hs.py, yolov6s_opt.py) on
     phase 6's cell: the hyper-search step (LinearAddBlocks) timed with its
     split and peak memory; the CSLA scales from its EMA; on one of its
     blocks in fp32 the CSLA theorem (a plain SGD step on the branches,
     folded, equals a masked step on the folded conv); the RepOpt graph
     (RealVGG blocks) re-initialised from the scales and its masked step
     timed; then folded and served as in phase 7;
 31. RepOpt's two stages through ``tools/train.py::main`` (S hs 2 epochs, then
     S opt 2 epochs with ``scales=`` the hs run's last_ckpt.pt; b32@640 bf16
     on 64 train images, each with an in-training eval of 64 val images at
     conf 0 through the kernel); then an upstream-format S ``.pt`` (whole
     fp16 modules of a stub ``yolov6`` package) read, in a child process
     where ``yolov6`` cannot be imported, by the eval CLI, the infer CLI and
     the fine-tune of a copy of configs/yolov6s_finetune.py (every tensor
     loaded equal to the file's, 1 epoch), each keep equal to the plain keep;
 32. INT8 quantisation, RepOpt's third stage (configs/repopt/yolov6s_opt_qat.py):
     phase 30's trained S folded and calibrated (the card's ranges held against
     the CPU's on 2 images, relative 1e-5, then 4 b32@640 batches of phase 6's
     cell), its weights fake-quantised, served b32@640 in bf16 quantised beside
     the same model in float (times, the fake quantisation's share of the call,
     a profile, the first keep against the plain keep); the QAT step from that
     EMA with the ranges and phase 30's masks (20 timed, the split, peak memory;
     the ranges bit-unchanged after it); ``--quant --calib`` then ``--quant``
     (1 epoch, its in-training eval quantised) through the train CLI on phase
     31's subset, the QAT checkpoint's ranges equal to the calibration's; and
     ``tools/quantize.py --eval`` on phase 13's gate checkpoint beside the eval
     CLI's float eval of the same file: PTQ mAP50 at most 0.05 below float.
Then it prints one JSON line of kernels, the nvidia-smi line of the card and,
last, ``{"ok": true, "device": {...}}``. It exits non-zero on any failure,
when there is no CUDA device, and when the ``yolov6_tpu_torch`` package is
not beside it.

The serving weights are random, from seeds: torch's default init, then
every conv re-drawn He-normal so activations stay O(1) through the full
depth, BottleRep alphas in [0.5, 1.5], and the head's class and box
predictions (zero weights at init, which would give every anchor the same
score) spread as in the CPU tests. The train model's convs are drawn
He-normal by a generator on the card; its BNs, alphas and its head's
prior-probability init are as built.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BATCH, IMG, NUM_CLASSES = 32, 640, 80
SERVE = dict(conf_thres=0.25, iou_thres=0.45, max_det=100)  # make_end2end_fn defaults
EVAL = dict(conf_thres=0.03, iou_thres=0.65, max_det=300, max_nms=8192, multi_label=True)
# (name, B, K, max_det, IoU) of the kernel-vs-plain phase
KEEP_SHAPES = [
    ("eval_protocol", 32, 8192, 300, 0.65),
    ("serving", 32, 8400, 100, 0.45),
    ("multi_label_max_nms", 4, 30000, 300, 0.65),
    ("infer", 1, 2000, 1000, 0.45),  # the infer CLI: one image, max_nms 2000, --max-det 1000
]
# CPU vs CUDA fp32 decode (TF32 off): the two sum the convolutions in other
# orders through ~40 layers
DECODE_BOX_TOL = dict(rtol=1e-4, atol=1e-2)  # pixels
DECODE_SCORE_TOL = dict(rtol=0.0, atol=1e-4)
# M runs through about twice S's conv layers, and its DFL boxes are sums of
# 17 bins: an H100 read 1.5e-2 px and 9.4e-5 against S's 1.2e-4 px and 3e-7
DECODE_TOL_M = (dict(rtol=1e-4, atol=5e-2), dict(rtol=0.0, atol=5e-4))
# the train phase: the JAX bench's train cell (bench.py:236-256)
TRAIN = dict(max_labels=32, labels=4, epoch=100, epochs=300, warmup_stepnum=10,
             max_stepnum=1000, warmup_steps=3, timed_steps=20, profiled_steps=3)
ATSS_STEPS = 3  # M's steps on the ATSS branch (the trainer's warmup epochs)
L_TIMED_STEPS = 5  # L's timed train steps, after TRAIN["warmup_steps"]
M_KD_TIMED_STEPS = 5  # phase 16's timed steps
# the distillation phases' KD (JAX tools/train.py's default temperature; the
# channel-wise KD on, so that every KD term runs)
DISTILL = dict(temperature=20, distill_feat=True)
# phase 17's teacher stage, in epochs (the gate's --teacher-epochs): with the
# default, as many as the student's 30, the student distilled from a teacher
# at mAP50 1.0 read 0.74 and 0.88 at its first evaluated checkpoint, so the
# gate's gain bar (0.20) passed in one of two runs (0.2585, 0.1140); with 10
# the gains read 0.49-0.54 in three of three, and the phase takes about 110 s
# less (PERF.md §6)
DISTILL_GATE_TEACHER_EPOCHS = 10
# the folded deploy graph against the train graph's eval forward, fp32, TF32
# off: max |diff| over a head map at most this share of the map's max |value|
# (an H100 read 3.6e-6 after 27 steps)
FOLD_REL_TOL = 1e-4
# serving the folded trained model: a low conf, so that the walk has work
# while the trained scores are still near the head's prior (0.01)
FOLD_SERVE = dict(conf_thres=0.001, iou_thres=0.65, max_det=300)


# the P6 family and the MBLA stage (phases 18-22): P6 serves, trains and
# evaluates at 1280, where its 160² + 80² + 40² + 20² = 34,000 anchors are
# capped at the serve's max_nms of 30,000 NMS candidates an image
P6_IMG = 1280
P6_NAMES = ("n6", "s6", "m6", "l6")
P6_SERVE_K = 30000
P6_TIMED_STEPS = 10  # phase 19's timed train steps
# phase 19: L6 trains at the largest of these batches whose peak, predicted
# from a probe at the smallest, leaves 10% of the card's memory free
L6_BATCHES = (32, 16, 8)
L6_FREE_SHARE = 0.10
# phase 20: the repro protocol's L6 row (configs/experiment/eval_640_repro.py)
L6_EVAL_SHRINK = 41
# phase 22: N6 through the train CLI on the first 64 images of phase 12's split
P6_TRAIN_CLI = dict(n_train=64, batch=8, epochs=2, stop_aug_last_n_epoch=1, workers=8)

# phase 23: the infer CLI at its defaults (conf 0.4, IoU 0.45, max_det 1000;
# the inferer's max_nms 2000) over data/images: random S scores each of its
# 8400 anchors above 0.4, so every image hands the keep the full 2000
# candidates. Then the learning gate's N on the gate's val images at 160 px,
# conf 0.25: most GT boxes must be found by a detection of their class at
# IoU >= 0.5 (the rescale to source pixels and the label rows)
INFER_CLI = dict(conf_thres=0.4, iou_thres=0.45, max_det=1000, max_nms=2000)
INFER_GATE = dict(img_size=160, conf_thres=0.25, iou=0.5, min_recall=0.5)
# phase 23: sha256 of cv2.imread(path).tobytes() for the repository's demo
# JPEGs (OpenCV 5.0.0 with libjpeg-turbo 3.1.2; tests/test_torch_jpeg.py holds
# the same constants against cv2), with the (h, w, 3) shape
DEMO_JPEGS = {
    "data/images/image1.jpg":
        ((480, 640, 3), "179170bc06d9e2340a9a7f6d74321566b7020dcfa33bcde37ce81e0bd7c7a99e"),
    "data/images/image2.jpg":
        ((640, 480, 3), "2c9baaefd517360019124d1be1cc52fc8e546442cbe2c8bd0adf0dd615ac4d82"),
    "data/images/image3.jpg":
        ((576, 768, 3), "29c29eae8982481328cc7c18c0667459c81644129c07adf210b5fc6177dd310f"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_MARKS = []  # (phase tag, host clock) at the start of each phase group


def phase_mark(tag: str) -> None:
    PHASE_MARKS.append((tag, time.perf_counter()))


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2, queue_ahead: bool = False) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls.

    ``queue_ahead`` first puts a spin kernel of about 10 ms on the stream, so
    that the host has queued every call before the first one starts: the
    events then time the device's work alone, not the host's launch rate
    (for a kernel shorter than its wrapper's host time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def clustered_candidates(seed: int, B: int, K: int, device, n_cls: int = 80):
    """NMS candidates as the selection stage hands them over: class-offset
    xyxy boxes in overlapping clusters in a 640 image, scores 0 below 0.2."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    centers = rng.uniform(40, 600, (B, 48, 2))
    c = np.take_along_axis(centers, rng.integers(0, 48, (B, K))[..., None], 1)
    c = c + rng.normal(0, 12, (B, K, 2))
    wh = rng.uniform(16, 120, (B, K, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    boxes += (rng.integers(0, n_cls, (B, K)) * 4096.0)[..., None]
    scores = rng.uniform(0, 1, (B, K))
    scores[scores < 0.2] = 0.0
    return (torch.tensor(boxes, dtype=torch.float32, device=device),
            torch.tensor(scores, dtype=torch.float32, device=device))


def sort_candidates(boxes, scores):
    """The candidates in the selection stage's order: scores descending, ties
    in index order (a stable sort)."""
    import torch

    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous(), scores


def keep_work_sorted(boxes, scores, idx, valid, tile: int):
    """(bytes, operations) the keep needs for these inputs once their order is
    known (scores sorted descending, every kept box distinct, as under the
    default rule). Bytes: every score, which the check of the order reads,
    the boxes up to the last candidate visited, and the outputs. Operations:
    per candidate up to the last one visited, 17 of IoU and test per kept box
    ahead of it, and 17 per pair of candidates within one tile of ``tile``.
    The last candidate visited is the one kept in the last row, or the last
    positive one when the rows do not fill."""
    import torch

    n_pos = (scores > 0).sum(1)
    last = torch.where(valid[:, -1], idx[:, -1].long(), n_pos - 1)  # [B]
    ahead = ((last[:, None] - idx.long()).clamp(min=0) * valid).sum()
    n = last + 1
    full, rem = n // tile, n % tile
    pairs = (full * (tile * (tile - 1) // 2) + rem * (rem - 1) // 2).sum()
    B = scores.shape[0]
    nbytes = (scores.numel() * 4 + int(n.sum()) * 16 + idx.numel() * 4 + valid.numel()
              + 5 * B)
    return nbytes, int(17 * (ahead + pairs))


def keep_work(boxes, scores, idx, valid, iou_thres):
    """(bytes, operations) the greedy keep needs for these inputs in any
    order (the argmax loop's count): each input read once and each output
    written once; per step run, one compare per candidate for the argmax and
    17 operations of IoU and test per candidate still alive. A step runs for
    each valid row, plus one that finds nothing alive when the loop ends
    early."""
    import torch

    B, K = scores.shape
    md = idx.shape[1]
    # idx, valid, and the kernel's path and tiles per image
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + idx.numel() * 4 + valid.numel() + 5 * B
    kept = torch.gather(boxes, 1, idx.long()[..., None].expand(-1, -1, 4))  # [B, md, 4]
    iw = (torch.minimum(kept[..., None, 2], boxes[:, None, :, 2])
          - torch.maximum(kept[..., None, 0], boxes[:, None, :, 0])).clamp(min=0)
    ih = (torch.minimum(kept[..., None, 3], boxes[:, None, :, 3])
          - torch.maximum(kept[..., None, 1], boxes[:, None, :, 1])).clamp(min=0)
    inter = iw * ih
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    area_k = (kept[..., 2] - kept[..., 0]) * (kept[..., 3] - kept[..., 1])
    iou = inter / (area_k[..., None] + area[:, None, :] - inter + 1e-12)
    killed = (iou > iou_thres) & valid[..., None]  # [B, md, K]: step j kills
    dead_before = torch.cumsum(killed.int(), 1) - killed.int() > 0
    dead_before |= (scores <= 0)[:, None, :]
    alive = (~dead_before).sum(-1)  # [B, md]
    n_valid = valid.sum(1)
    steps = torch.clamp(n_valid + (n_valid < md).long(), max=md)
    ran = torch.arange(md, device=idx.device)[None] < steps[:, None]
    ops = int((ran * (K + 17 * alive)).sum())
    return nbytes, ops


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def randomize_weights(model, seed: int) -> None:
    """He-normal convs, small biases, and the head spread (see module doc)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            head_pred = ".cls_preds." in name or ".reg_preds." in name
            if p.dim() == 4:
                fan_in = p[0].numel() if "upsample_transpose" not in name else p.shape[0] * 4
                std = (0.3 if head_pred else math.sqrt(2.0)) / math.sqrt(fan_in)
                new = torch.randn(p.shape, generator=gen) * std
            elif ".cls_preds." in name:
                new = torch.rand(p.shape, generator=gen) * 5.0 - 4.0
            elif ".reg_preds." in name:
                new = torch.rand(p.shape, generator=gen) * 2.0 + 1.0
            elif name.endswith(".alpha"):
                new = torch.rand(p.shape, generator=gen) + 0.5
            else:
                new = torch.rand(p.shape, generator=gen) * 0.2 - 0.1
            p.copy_(new.to(p.device))


def profile_calls(fn, card: str, calls: int = 3, tag: str = "[5]",
                  what: str = "bf16 serve calls", unit: str = "call") -> None:
    """Where the device time of ``calls`` calls of ``fn`` goes: kernel time by
    name from torch.profiler, and the device's idle share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
    window_us = start.elapsed_time(end) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        log(f"{tag} profile: the profiler saw no device time; breakdown not measured [{card}]")
        return None
    launches = sum(e.count for e in kernels) / calls
    log(f"{tag} profile of {calls} {what}: window {window_us / calls:.1f} us/{unit}, "
        f"kernels {busy_us / calls:.1f} us/{unit} in {launches:.0f} launches, device idle "
        f"{1 - busy_us / window_us:.3f} of the window [{card}]")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in ranked[:12] + [e for e in ranked[12:] if "greedy_nms" in e.key]:
        log(f"{tag}   {e.self_device_time_total / calls:9.1f} us/{unit} "
            f"{e.count // calls:4d}x  {e.key[:90]}")
    return dict(window_us=window_us / calls, busy_us=busy_us / calls, launches=launches,
                idle=1 - busy_us / window_us)

def init_train_weights(model, gen) -> None:
    """He-normal convs drawn by ``gen`` (a generator on the card); BNs and the
    head's prior-probability init (every ``*_preds*`` conv, the training
    recipes' included) stay as built."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4 and "_preds" not in name:
                fan_in = p[0].numel() if "upsample_transpose" not in name else p.shape[0] * 4
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                        * math.sqrt(2.0 / fan_in))


def bench_batch(batch: int, img: int, max_labels: int, labels: int, dev):
    """The JAX bench's train data (bench.py:246-251): uint8 images, and
    ``labels`` boxes an image with classes in 0..79 and cxcywh in U(0.2, 0.6),
    the other rows -1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (batch, img, img, 3), np.uint8)
    targets = np.full((batch, max_labels, 5), -1.0, np.float32)
    targets[:, :labels, 0] = rng.integers(0, NUM_CLASSES, (batch, labels))
    targets[:, :labels, 1:] = rng.uniform(0.2, 0.6, (batch, labels, 4))
    return torch.from_numpy(images).to(dev), torch.from_numpy(targets).to(dev)


def time_step_phases(step, images, targets, epoch) -> dict:
    """One step with CUDA events between its phases, in ms by part (queue
    work ahead of it, or the parts include the host's launch time): the
    forward with the input preparation, the teacher's forward (a
    distillation step), the loss with the assignment (with fuse-AB, the
    anchor-free ``loss`` and the anchor-based ``loss AB``, its flattening
    included), the backward, and optimizer+EMA. The step's two public
    halves bound the optimizer phase; the rest is bounded by wrapping the
    step's loss functions and the teacher's forward."""
    import torch

    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    def wrap(fn, enter, leave):
        def timed(*args, **kwargs):
            if enter:
                mark(enter)
            out = fn(*args, **kwargs)
            if leave:
                mark(leave)
            return out
        return timed

    saved = step.compute_loss, step.compute_loss_ab
    ab = step.compute_loss_ab is not None
    step.compute_loss = wrap(saved[0], "loss", "loss AB" if ab else "backward")
    if ab:
        step.compute_loss_ab = wrap(saved[1], None, "backward")
    if step.teacher is not None:
        step.teacher.forward = wrap(step.teacher.forward, "teacher forward", None)
    try:
        mark("forward")
        step.forward_backward(images, targets, epoch=epoch)
        mark("optimizer+EMA")
        step.update(epoch)
        mark("end")
    finally:
        step.compute_loss, step.compute_loss_ab = saved
        if step.teacher is not None:
            del step.teacher.forward
    torch.cuda.synchronize()
    split = {}
    for (label, a), (_, b) in zip(marks, marks[1:]):
        split[label] = split.get(label, 0.0) + a.elapsed_time(b)
    return split


def recipe_step(cfg, recipe, dev, gen, epochs: int, img: int = IMG):
    """The train model and ``make_train_step``'s loss arguments of a recipe:
    None (``ComputeLoss``), ``"fuse_ab"`` (the fuse-AB head and
    ``ComputeLossAB``) or ``"distill"`` (a fuse-AB teacher of the same
    config, train form in eval mode, its convs He-normal and its head spread
    as in the CPU tests, and the distill-NS student with
    ``ComputeLossDistillNS`` for N/S, a plain student with
    ``ComputeLossDistill`` for M/L). Returns (model, loss, recipe kwargs)."""
    import torch

    from yolov6_tpu_torch.losses.loss import ComputeLoss
    from yolov6_tpu_torch.losses.loss_distill import ComputeLossDistill
    from yolov6_tpu_torch.losses.loss_distill_ns import ComputeLossDistillNS
    from yolov6_tpu_torch.losses.loss_fuseab import ComputeLossAB
    from yolov6_tpu_torch.models.yolo import build_model

    head = cfg.model.head
    ns = recipe == "distill" and cfg.model.type in ("YOLOv6n", "YOLOv6s")
    model = build_model(cfg, num_classes=NUM_CLASSES, deploy=False, device=dev,
                        fuse_ab=recipe == "fuse_ab", distill_ns=ns)
    init_train_weights(model, gen)
    common = dict(num_classes=NUM_CLASSES, ori_img_size=img, iou_type=head.iou_type,
                  fpn_strides=tuple(head.strides))
    loss_fn = ComputeLoss(warmup_epoch=0, use_dfl=head.use_dfl, reg_max=head.reg_max, **common)
    if recipe == "fuse_ab":
        return model, loss_fn, dict(compute_loss_ab=ComputeLossAB(
            anchors_init=tuple(map(tuple, head.anchors_init)), **common))
    if recipe == "distill":
        teacher = build_model(cfg, num_classes=NUM_CLASSES, deploy=False, device=dev,
                              fuse_ab=True)
        init_train_weights(teacher, gen)
        with torch.no_grad():
            for name, p in teacher.named_parameters():
                if "_preds" not in name:
                    continue
                if p.dim() == 4:
                    p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.3
                            / math.sqrt(p[0].numel()))
                else:
                    low, high = (-4.0, 1.0) if "cls_preds" in name else (1.0, 3.0)
                    p.uniform_(low, high, generator=gen)
        distill = (ComputeLossDistillNS if ns else ComputeLossDistill)(
            warmup_epoch=0, use_dfl=head.use_dfl, reg_max=head.reg_max,
            distill_weight=dict(head.distill_weight), max_epoch=epochs, **DISTILL, **common)
        return model, None, dict(teacher=(teacher, distill))
    return model, loss_fn, {}


def train_phase(cfg, label: str, dev, card: str, tag: str, timed_steps: int,
                profile: bool = True, atss_steps: int = 0, recipe=None, batch: int = BATCH,
                img: int = IMG, repopt_scales=None, init_state=None, quant=None):
    """A training step at ``batch``@``img`` (b32@640 unless given) in bf16 on
    the bench's cell (phases 6, 9, 10, the recipes' 14-16, 19, 21, 29, 30 and
    32, ``recipe`` as ``recipe_step`` takes it): ``TRAIN["warmup_steps"]``
    steps, ``timed_steps`` timed, one split into its phases, optionally a
    profile window; then ``atss_steps`` steps on the ATSS branch. With
    ``repopt_scales`` (a RepOpt config's model) the RealVGG convs are
    re-initialised from the scales and the step masks their gradients; with
    ``init_state`` (a train-form state dict) the model starts from it
    instead, and the masks apply without the re-init (the trainer's
    fine-tune). ``quant`` is the step's QAT ranges (``make_train_step``).
    Returns the step and its numbers."""
    import torch

    from yolov6_tpu_torch.core.train_step import make_train_step
    from yolov6_tpu_torch.solver.build import scale_hyperparams_for_batch

    t = TRAIN
    head, sol = cfg.model.head, cfg.solver
    model, loss_fn, recipe_kw = recipe_step(cfg, recipe, dev,
                                            torch.Generator(device=dev).manual_seed(0),
                                            t["epochs"], img)
    if init_state is not None:
        model.load_state_dict(init_state, strict=True)
    if quant is not None:
        recipe_kw["quant"] = quant
    if repopt_scales is not None and init_state is not None:
        from yolov6_tpu_torch.solver.repoptimizer import generate_gradient_masks

        recipe_kw["grad_masks"] = generate_gradient_masks(model, repopt_scales)
    elif repopt_scales is not None:
        from yolov6_tpu_torch.solver.repoptimizer import generate_gradient_masks, reinitialize

        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        reinitialize(model, repopt_scales)
        recipe_kw["grad_masks"] = generate_gradient_masks(model, repopt_scales)
        moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
        assert sorted(moved) == sorted(recipe_kw["grad_masks"]), "the re-init moved other tensors"
        log(f"{tag} re-initialised {len(moved)} RealVGG convs from {len(repopt_scales)} blocks' "
            "CSLA scales; the step masks their gradients")
    solver = scale_hyperparams_for_batch(dict(
        lr0=sol.lr0, lrf=sol.lrf, momentum=sol.momentum, weight_decay=sol.weight_decay,
        warmup_epochs=sol.warmup_epochs, warmup_momentum=sol.warmup_momentum,
        warmup_bias_lr=sol.warmup_bias_lr, lr_scheduler="Cosine"), batch)
    step = make_train_step(model, loss_fn, solver, t["max_stepnum"], t["epochs"], batch,
                           t["warmup_stepnum"], (img, img), half=True, device=dev, **recipe_kw)
    n_params = sum(p.numel() for p in model.parameters())
    n_alpha = sum(1 for n, _ in model.named_parameters() if n.endswith(".alpha"))
    images, targets = bench_batch(batch, img, t["max_labels"], t["labels"], dev)
    epoch = t["epoch"]
    names = ["total", "iou", "dfl", "cls"] + (["cwd"] if step.teacher is not None else [])

    losses, applied = [], []

    def one_step(use_atss=False):
        before = step.ema_updates.clone()
        loss, comp = step(images, targets, epoch, use_atss=use_atss)
        losses.append(torch.cat([loss[None], comp]))
        applied.append(step.ema_updates - before)

    for _ in range(t["warmup_steps"]):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed_steps):
        one_step()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / timed_steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # one more step queued ahead of the split, so that the device has work
    # while the host queues the split step: an idle queue would add the
    # host's launch time to each part (M KD's parts summed to 387 ms against
    # 234 ms a step from an idle queue)
    one_step()
    split = time_step_phases(step, images, targets, epoch)
    applied_all = torch.stack(applied).tolist()
    rows = torch.stack(losses).tolist()
    n_applied = sum(applied_all)
    n_held = len(applied_all) - n_applied
    what = {None: "", "fuse_ab": ", fuse-AB head + ComputeLossAB",
            "distill": f", {type(step.compute_loss).__name__} against a fuse-AB teacher "
                       f"(T {DISTILL['temperature']}, channel-wise KD, epoch {epoch} of "
                       f"{t['epochs']})"}[recipe]
    log(f"{tag} trained {label} ({n_params / 1e6:.2f} M params, train form, {n_alpha} BottleRep "
        f"alphas; DFL {bool(head.use_dfl)}{what}) b{batch}@{img} bf16: {t['warmup_steps']} + "
        f"{timed_steps} steps, {step_ms:.3f} ms/step = {batch / step_ms * 1e3:.1f} imgs/s [{card}]")
    log(f"{tag} one step split: " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + f" (sum {sum(split.values()):.3f}) [{card}]")
    log(f"{tag} peak memory allocated {peak_gib:.2f} GiB over the timed steps; "
        f"{n_applied} steps applied, {n_held} held; loss [{', '.join(names)}] first "
        f"{[round(x, 5) for x in rows[0]]}, last {[round(x, 5) for x in rows[-1]]}")
    assert all(math.isfinite(x) for row in rows for x in row), f"a loss is not finite: {rows}"
    assert n_applied > 0 and n_held > 0, f"applied {n_applied}, held {n_held}"
    assert int(step.step) == len(rows) + 1
    if head.use_dfl:
        assert all(row[2] > 0 for row in rows), "a DFL component is not positive"
    if step.teacher is not None:
        assert all(row[4] > 0 for row in rows), "the channel-wise KD is not positive"
    if profile:
        profile_calls(lambda: step(images, targets, epoch), card, calls=t["profiled_steps"],
                      tag=tag, what="bf16 train steps", unit="step")
    if atss_steps:
        losses.clear()
        torch.cuda.synchronize()
        start.record()
        for _ in range(atss_steps):
            one_step(use_atss=True)
        end.record()
        end.synchronize()
        atss_ms = start.elapsed_time(end) / atss_steps
        rows = torch.stack(losses).tolist()
        log(f"{tag} {atss_steps} steps on the ATSS branch: {atss_ms:.3f} ms/step = "
            f"{batch / atss_ms * 1e3:.1f} imgs/s; loss [{', '.join(names)}] "
            f"{[[round(x, 5) for x in row] for row in rows]} [{card}]")
        assert all(math.isfinite(x) for row in rows for x in row), "ATSS: a loss is not finite"
        assert all(row[2] > 0 for row in rows) or not head.use_dfl
    torch.cuda.synchronize()
    return step, dict(step_ms=step_ms, imgs_per_s=batch / step_ms * 1e3, split_ms=split,
                      peak_gib=peak_gib, applied=n_applied, held=n_held, params=n_params,
                      batch=batch, img=img)


def fold_and_serve_phase(cfg, label: str, step, images, dev, card: str, tag: str) -> dict:
    """Phases 7, 9, 14, 15, 19 and 21: fold the trained model and its EMA into the
    deploy graph of ``cfg`` (the training recipes' train-only branches
    dropped), hold each against its train form's eval forward in fp32, and
    serve the folded model, its first keep with a candidate held against
    the plain emit-once keep; returns the NMS kernel's launches in that
    serve, its tiles an image and the keep's index error."""
    import torch

    from yolov6_tpu_torch.layers.reparam import fold_to_deploy
    from yolov6_tpu_torch.models.end2end import make_end2end_fn
    from yolov6_tpu_torch.models.yolo import build_model
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    x = images[:2].permute(0, 3, 1, 2).float().contiguous() / 255.0
    deployed = {}
    try:
        for name, train_model in (("model", step.model), ("ema", step.ema)):
            deploy = build_model(cfg, num_classes=NUM_CLASSES, deploy=True, device=dev)
            deploy.load_state_dict(fold_to_deploy(train_model.state_dict(), deploy), strict=True)
            was_training = train_model.training
            train_model.eval()
            with torch.no_grad():
                want, _ = train_model(x)
                got, _ = deploy(x)
            train_model.train(was_training)
            worst = 0.0
            for key in ("cls", "reg"):
                for g, w in zip(got[key], want[key]):
                    rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                    worst = max(worst, rel)
            log(f"{tag} folded {label} {name}: deploy fp32 forward vs train-form eval forward on "
                f"2 images, max |diff| / max |value| over the head maps {worst:.3e} (tolerance "
                f"{FOLD_REL_TOL})")
            assert worst <= FOLD_REL_TOL, f"folded {name} differs from its train form: {worst}"
            deployed[name] = deploy
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    serve = make_end2end_fn(deployed["model"], **FOLD_SERVE, with_preprocess=True, half=True,
                            device=dev)
    greedy_nms.launches = 0
    with KeepRecorder("serve") as rec:
        num_dets, boxes, scores, _ = serve(images)
        torch.cuda.synchronize()
    launches = greedy_nms.launches
    assert launches > 0, "serving the folded model did not launch the NMS kernel"
    batch, img = images.shape[0], images.shape[1]
    walk = rec.check(f"{tag} folded serve", batch, labels=("serve",))
    first = walk["first"]["serve"]
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
    total = int(num_dets.sum())
    assert total > 0, "serving the folded trained model found no detections"
    log(f"{tag} served the folded trained {label} b{batch}@{img} bf16 at {FOLD_SERVE}: {total} "
        f"detections, {launches} NMS kernel launch(es), the tile walk in all {batch} images, "
        f"{walk['tiles_visited']:.2f} tiles/image, the keep (B={first['boxes'].shape[0]} "
        f"K={first['boxes'].shape[1]}, {first['kept']} kept) equal to the plain emit-once keep; "
        f"max score {float(scores.max()):.4f}")
    return dict(launches=launches, tiles_visited=walk["tiles_visited"],
                max_abs_err=walk["max_abs_err"], K=int(first["boxes"].shape[1]))


def forward_decode(x_uint8, model, half):
    """The serve's preprocessing, forward and decode, without the NMS."""
    import torch

    x = x_uint8.permute(0, 3, 1, 2).to(torch.bfloat16 if half else torch.float32)
    x = x.contiguous().flip(1) / 255.0
    with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=half):
        head, _ = model(x)
    return model.decode(head)


def deploy_model(cfg, seed: int, dev):
    """The deploy graph of ``cfg`` (80 classes) with seeded weights."""
    import torch

    from yolov6_tpu_torch.models.yolo import build_model

    torch.manual_seed(seed)
    model = build_model(cfg, num_classes=NUM_CLASSES, deploy=True, device=dev)
    randomize_weights(model, seed=seed)
    return model


def serve_phase(cfg, label: str, model, images_np, images, dev, card: str, tag: str,
                decode_tol=(DECODE_BOX_TOL, DECODE_SCORE_TOL)):
    """Phases 3 and 8: ``model`` serves b32@640 in fp32 (TF32 off) through
    ``make_end2end_fn``; the NMS kernel must launch and take the tile walk in
    every image and find detections; the default keep must equal the plain
    emit-once keep and ``'pallas'`` the plain loop on the same predictions at
    the serving setting and the eval protocol; the CPU decode of two images
    must agree with the CUDA decode within ``decode_tol`` (boxes, scores);
    and the kernel is timed on the served candidates against its plain
    version. Returns the kernel's numbers."""
    import torch

    from yolov6_tpu_torch.models.end2end import make_end2end_fn
    from yolov6_tpu_torch.models.yolo import build_model
    from yolov6_tpu_torch.ops import nms as nms_mod
    from yolov6_tpu_torch.ops.cuda.nms_kernel import TILE, greedy_nms, greedy_nms_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n_params = sum(p.numel() for p in model.parameters())
    serve = make_end2end_fn(model, **SERVE, with_preprocess=True, half=False, device=dev)

    greedy_nms.launches = 0
    num_dets, boxes, scores, classes = serve(images)
    torch.cuda.synchronize()
    launches = greedy_nms.launches
    assert launches > 0, f"{label}: serving did not launch the NMS kernel"
    path = greedy_nms.last_path.tolist()
    tiles = float(greedy_nms.last_tiles.float().mean())
    assert path == [1] * BATCH, f"{label} serving: not every image took the tile walk: {path}"
    assert num_dets.shape == (BATCH, 1) and boxes.shape == (BATCH, SERVE["max_det"], 4)
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
    total = int(num_dets.sum())
    assert total > 0, f"{label}: serving found no detections"
    log(f"{tag} served {label} ({n_params / 1e6:.2f} M params) b{BATCH}@{IMG} fp32: "
        f"{total} detections, {launches} NMS kernel launch(es), the tile walk in all "
        f"{BATCH} images, {tiles:.2f} tiles/image")

    def plain_emit_once(preds, conf_thres, iou_thres, max_det, max_nms=30000,
                        multi_label=False):
        cands = nms_mod._select_candidates(preds, conf_thres, max_nms, multi_label, False, None)
        return nms_mod._keep_and_gather(cands, greedy_nms_plain, True, max_det, iou_thres)

    cpu_model = build_model(cfg, num_classes=NUM_CLASSES, deploy=True, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        preds = forward_decode(images, model, half=False)
        counts, walk_tiles = {}, {}
        for setting, kw in (("serving", SERVE), ("eval protocol", EVAL)):
            dets_k, valid_k = nms_mod.non_max_suppression(preds, **kw)
            torch.cuda.synchronize()
            paths = greedy_nms.last_path.tolist()
            assert paths == [1] * BATCH, f"{setting}: not every image took the tile walk: {paths}"
            walk_tiles[setting] = float(greedy_nms.last_tiles.float().mean())
            dets_p, valid_p = plain_emit_once(preds, **kw)
            assert torch.equal(valid_k, valid_p) and torch.equal(dets_k, dets_p), \
                f"{label} {setting}: the default keep differs from the plain emit-once keep"
            pal_k, pal_valid_k = nms_mod.non_max_suppression(preds, **kw, method="pallas")
            pal_p, pal_valid_p = nms_mod.non_max_suppression(preds, **kw, method="loop")
            assert torch.equal(pal_valid_k, pal_valid_p) and torch.equal(pal_k, pal_p), \
                f"{label} {setting}: 'pallas' differs from the plain loop"
            counts[setting] = (int(valid_k.sum()), int(pal_valid_k.sum()))
            if setting == "serving":
                assert torch.equal(valid_k.sum(1, keepdim=True, dtype=torch.int32), num_dets), \
                    f"{label} serving: serve() differs from forward + decode + NMS"
        log(f"{tag} same predictions through the plain keeps: the default equal to the plain "
            f"emit-once keep, 'pallas' equal to 'loop', at the serving setting and at the "
            f"eval protocol ((default, pallas) detections: {counts}); the default keep took "
            f"the tile walk in every image of both (tiles/image: {walk_tiles})")

        # two of the images on the CPU, fp32
        cpu_serve = make_end2end_fn(cpu_model, **SERVE, with_preprocess=True, half=False,
                                    device="cpu")
        cpu_num, _, _, _ = cpu_serve(images_np[:2])
        assert int(cpu_num.sum()) > 0, f"{label}: CPU serving found no detections"
        preds_cpu = forward_decode(torch.from_numpy(images_np[:2]), cpu_model, half=False)
        preds_gpu = preds[:2].cpu()
        box_tol, score_tol = decode_tol
        torch.testing.assert_close(preds_cpu[..., :4], preds_gpu[..., :4], **box_tol)
        torch.testing.assert_close(preds_cpu[..., 4:], preds_gpu[..., 4:], **score_tol)
        box_err = float((preds_cpu[..., :4] - preds_gpu[..., :4]).abs().max())
        score_err = float((preds_cpu[..., 4:] - preds_gpu[..., 4:]).abs().max())
        log(f"{tag} CPU decode of 2 images vs CUDA: max |box| diff {box_err:.3e} px, "
            f"max |score| diff {score_err:.3e} (tolerance boxes {box_tol}, "
            f"scores {score_tol}); CPU serve {cpu_num.flatten().tolist()} vs CUDA "
            f"{num_dets[:2].flatten().tolist()} detections")

        # the kernel at the main path's shape, on the main path's own candidates
        _, nms_boxes, cand_scores, _ = nms_mod._select_candidates(
            preds, SERVE["conf_thres"], 30000, False, False, None)
        nms_boxes, cand_scores = nms_boxes.contiguous(), cand_scores.contiguous()
        md, iou = SERVE["max_det"], SERVE["iou_thres"]
        max_abs_err = 0.0
        for emit_once in (False, True):  # the default rule last: its outputs are used below
            idx_k, valid_k = greedy_nms(nms_boxes, cand_scores, md, iou, emit_once=emit_once)
            idx_p, valid_p = greedy_nms_plain(nms_boxes, cand_scores, md, iou,
                                              emit_once=emit_once)
            assert torch.equal(idx_k, idx_p) and torch.equal(valid_k, valid_p), \
                f"{label} served candidates, emit_once={emit_once}: the kernel differs from plain"
            assert (greedy_nms.last_path == 1).all()
            max_abs_err = max(max_abs_err, float((idx_k - idx_p).abs().max()))
        ms = cuda_ms(lambda: greedy_nms(nms_boxes, cand_scores, md, iou), iters=20,
                     queue_ahead=True)
        call_ms = cuda_ms(lambda: greedy_nms(nms_boxes, cand_scores, md, iou), iters=20)
        plain_ms = cuda_ms(lambda: greedy_nms_plain(nms_boxes, cand_scores, md, iou),
                           iters=3, warmup=1)
        bound, by = bound_ms(*keep_work_sorted(nms_boxes, cand_scores, idx_k, valid_k, TILE))
        any_bound, any_by = bound_ms(*keep_work(nms_boxes, cand_scores, idx_k, valid_k, iou))
        log(f"{tag} greedy_nms on {label}'s served candidates B={BATCH} K={nms_boxes.shape[1]} "
            f"max_det={md}, both rules equal to plain: kernel {ms:.4f} ms, per call "
            f"{call_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.5f} ms "
            f"({by}; in any order {any_bound:.5f} ms, {any_by}) [{card}]")
    return dict(launches=launches, path=path[0], tiles_visited=tiles, max_abs_err=max_abs_err,
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                any_order_bound_ms=any_bound, K=nms_boxes.shape[1], max_det=md)


def time_serve(model, label: str, images, dev, card: str, tag: str, profile_tag=None):
    """Phases 4/5, 8, 10 and 21: bf16 fwd+decode and serve of ``images`` (b32@640)
    by CUDA events (10 calls after 3), then a profile window when
    ``profile_tag`` is given; returns the NMS kernel's launches in one serve
    call, which must take the tile walk, and the two times."""
    import torch

    from yolov6_tpu_torch.models.end2end import make_end2end_fn
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms

    torch.backends.cudnn.allow_tf32 = True
    serve16 = make_end2end_fn(model, **SERVE, with_preprocess=True, half=True, device=dev)
    greedy_nms.launches = 0
    n16 = serve16(images)[0]
    torch.cuda.synchronize()
    launches = greedy_nms.launches
    assert launches > 0, f"{label}: bf16 serving did not launch the NMS kernel"
    batch, img = images.shape[0], images.shape[1]
    assert greedy_nms.last_path.tolist() == [1] * batch, f"{label} bf16: not every image walked"
    assert int(n16.sum()) > 0, f"{label}: bf16 serving found no detections"
    with torch.inference_mode():
        fd_ms = cuda_ms(lambda: forward_decode(images, model, half=True), iters=10, warmup=3)
    sv_ms = cuda_ms(lambda: serve16(images), iters=10, warmup=3)
    log(f"{tag} bf16 {label} b{batch}@{img}: fwd+decode {fd_ms:.3f} ms = "
        f"{batch / fd_ms * 1e3:.1f} imgs/s; fwd+decode+NMS (serve) {sv_ms:.3f} ms = "
        f"{batch / sv_ms * 1e3:.1f} imgs/s; {int(n16.sum())} detections, {launches} NMS kernel "
        f"launch(es) a call, the tile walk in all {batch} images [{card}]")
    out = dict(launches=launches, fwd_decode_ms=fd_ms, serve_ms=sv_ms,
               imgs_per_s=batch / sv_ms * 1e3)
    if profile_tag:
        out["profile"] = profile_calls(lambda: serve16(images), card, tag=profile_tag)
    return out


# the eval phase's set: 160 PNG images in four sizes (w, h), so that the
# loader both shrinks (INTER_AREA, 768x576) and enlarges (INTER_LINEAR, 320x240)
# (160, as the train split: at 320 each the script outran its time limit on a
# slower host)
EVAL_SET = dict(n_val=160, seed=0, sizes=[(640, 480), (480, 640), (768, 576), (320, 240)])


def write_eval_set(root: str, card: str) -> dict:
    """The synthetic val set under ``root``, its data dict naming 80 classes
    (the generator draws the first 4)."""
    import glob

    from yolov6_tpu_torch.data.synth_detect import CLASS_NAMES, generate_synth_dataset
    from yolov6_tpu_torch.utils.data_config import load_data_config

    t0 = time.perf_counter()
    data = load_data_config(generate_synth_dataset(root, n_train=0, img_size=IMG, **EVAL_SET))
    secs = time.perf_counter() - t0
    files = glob.glob(os.path.join(data["val"], "*.png"))
    nbytes = sum(os.path.getsize(f) for f in files)
    assert len(files) == EVAL_SET["n_val"]
    data["nc"] = NUM_CLASSES
    data["names"] = CLASS_NAMES + [f"class{i}" for i in range(len(CLASS_NAMES), NUM_CLASSES)]
    log(f"[11] wrote {len(files)} PNG images of (w, h) {EVAL_SET['sizes']}: {nbytes} bytes in "
        f"{secs:.2f} s (one host thread) [{card}]")
    return data


def perfect_mock_phase(data: dict, dev, card: str) -> None:
    """tests/test_eval_pipeline.py's perfect mock through the port's loader,
    Evaler (on the card) and evaluator: detections at the letterboxed GT."""
    import torch

    from yolov6_tpu_torch.core.evaler import Evaler

    evaler = Evaler(dict(data), batch_size=BATCH, img_size=IMG, device=dev)
    loader = evaler.init_data(None, "val")
    current = {}

    class Batches:
        def __len__(self):
            return len(loader)

        def __iter__(self):
            for batch in loader:
                current["labels"] = batch[1]
                yield batch

    def mock_infer(imgs):
        b, h, w, _ = imgs.shape
        dets = torch.zeros((b, 300, 6), device=imgs.device)
        valid = torch.zeros((b, 300), dtype=torch.bool, device=imgs.device)
        for i, lb in enumerate(current["labels"]):
            lb = torch.from_numpy(lb[lb[:, 0] >= 0]).to(imgs.device)
            cx, cy, bw, bh = lb[:, 1] * w, lb[:, 2] * h, lb[:, 3] * w, lb[:, 4] * h
            dets[i, :len(lb)] = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2,
                                             torch.full_like(cx, 0.9), lb[:, 0]], -1)
            valid[i, :len(lb)] = True
        return dets, valid

    evaler._infer = mock_infer
    rows = evaler.predict_model(None, Batches())
    ap50, ap = evaler.eval_model(rows, None, loader)
    log(f"[11] perfect mock through the port's loader, Evaler and evaluator: {len(rows)} rows, "
        f"AP50 {ap50:.5f}, AP {ap:.5f} (need > 0.99 and > 0.95)")
    assert ap50 > 0.99 and ap > 0.95, f"perfect mock: AP50 {ap50}, AP {ap}"


class KeepRecorder:
    """Records, while active, every launch of the default keep: its path,
    tiles per image and K; and, for each ``label`` set while it is active,
    the inputs and outputs of the first launch that has a candidate, which
    ``check`` holds against the plain keep (the eval paths' kernel checks)."""

    def __init__(self, label: str = "eval", record_all: bool = False):
        from yolov6_tpu_torch.ops import nms as nms_mod

        self.nms_mod = nms_mod
        self.label = label
        self.walks = []
        self.first = {}
        self.record_all = record_all  # keep every launch's inputs (``check_all``)
        self.all = []

    def __enter__(self):
        from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms

        keep, self.rule = self.nms_mod._KEEPS[None]
        self.keep = keep

        def recording_keep(boxes, scores, max_det, iou_thres, emit_once=True):
            idx, valid = keep(boxes, scores, max_det, iou_thres, emit_once=emit_once)
            tiles = greedy_nms.last_tiles.clone()
            self.walks.append((greedy_nms.last_path.clone(), tiles, boxes.shape[1]))
            if self.record_all:
                self.all.append(dict(boxes=boxes.clone(), scores=scores.clone(), max_det=max_det,
                                     iou_thres=iou_thres, emit_once=emit_once, idx=idx.clone(),
                                     valid=valid.clone(), tiles=tiles))
            if self.label not in self.first and bool((scores > 0).any()):
                self.first[self.label] = dict(
                    boxes=boxes.clone(), scores=scores.clone(), max_det=max_det,
                    iou_thres=iou_thres, emit_once=emit_once, idx=idx.clone(),
                    valid=valid.clone(), tiles=tiles)
            return idx, valid

        self.nms_mod._KEEPS[None] = (recording_keep, self.rule)
        return self

    def __exit__(self, *exc):
        self.nms_mod._KEEPS[None] = (self.keep, self.rule)

    def check(self, what: str, n_images: int, labels=("eval",)) -> dict:
        """Every image took the tile walk and the walk visited tiles; for
        each of ``labels``, its first launch with a candidate equals the
        plain keep under its rule, and each of its images with a candidate
        visited a tile. Returns the launches, the mean tiles an image, the
        K seen, the largest index error and, by label, that first launch."""
        import torch

        from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms_plain

        paths = torch.cat([p for p, _, _ in self.walks]).tolist()
        assert paths == [1] * len(paths), f"{what}: not every image took the tile walk"
        assert len(paths) >= n_images, f"{what}: {len(paths)} images walked, {n_images} evaluated"
        tiles = float(torch.cat([t for _, t, _ in self.walks]).float().mean())
        assert tiles > 0, f"{what}: the walk visited no tile"
        err = 0.0
        for label in labels:
            assert label in self.first, f"{what}: no launch of {label} had a candidate"
            f = self.first[label]
            idx_p, valid_p = greedy_nms_plain(f["boxes"], f["scores"], f["max_det"],
                                              f["iou_thres"], emit_once=f["emit_once"])
            assert torch.equal(f["idx"], idx_p) and torch.equal(f["valid"], valid_p), \
                f"{what}: the kernel's keep differs from the plain keep on {label}'s candidates"
            has = (f["scores"] > 0).any(1)
            assert (f["tiles"][has] > 0).all(), f"{what}: an image of {label} visited no tile"
            f["kept"] = int(f["valid"].sum())
            err = max(err, float((f["idx"] - idx_p).abs().max()))
        return dict(launches=len(self.walks), tiles_visited=tiles,
                    K=sorted({k for _, _, k in self.walks}), max_abs_err=err,
                    first={label: self.first[label] for label in labels})


    def check_all(self, what: str):
        """Every recorded launch took the tile walk and equals the plain keep
        under its rule; returns the launches and the largest index error."""
        import torch

        from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms_plain

        assert self.record_all and len(self.all) == len(self.walks) > 0, what
        err = 0.0
        for i, f in enumerate(self.all):
            assert bool((self.walks[i][0] == 1).all()), f"{what}: launch {i} took no tile walk"
            idx_p, valid_p = greedy_nms_plain(f["boxes"], f["scores"], f["max_det"],
                                              f["iou_thres"], emit_once=f["emit_once"])
            assert torch.equal(f["idx"], idx_p) and torch.equal(f["valid"], valid_p), \
                f"{what}: launch {i}'s keep differs from the plain keep"
            err = max(err, float((f["idx"] - idx_p).abs().max()))
        return self.all, err


def split_per_batch(batch_split) -> dict:
    """``Evaler.batch_split`` as means a batch, in ms."""
    n = len(batch_split)
    return dict(loader_ms=sum(r["loader_s"] for r in batch_split) / n * 1e3,
                queue_ms=sum(r["launch_s"] for r in batch_split) / n * 1e3,
                h2d_ms=sum(r["h2d_ms"] for r in batch_split) / n,
                convert_ms=sum(r["convert_s"] for r in batch_split) / n * 1e3)


def eval_phase(model, label: str, data: dict, dev, card: str, rect: bool = False,
               img: int = IMG, shrink: int = 0, tag: str = "[11]") -> dict:
    """``Evaler.init_data``, ``predict_model`` and ``eval_model`` of ``model``
    at b32@``img`` (640 unless given; ``shrink`` the repro protocol's
    ``shrink_size``) in bf16 at the eval protocol (conf 0.03, IoU 0.65,
    multi-label, max_nms 8192, max_det 300), with the asserts of the module
    doc, then a profiled pass for the device's own time and idle share, a
    pass over batches built beforehand, and the kernel timed on the counted
    run's first batch with a candidate. Returns the numbers."""
    import torch

    from yolov6_tpu_torch.core.evaler import Evaler
    from yolov6_tpu_torch.ops.cuda.nms_kernel import TILE, greedy_nms, greedy_nms_plain

    what = f"{label}{' rect' if rect else ''}{f' shrink {shrink}' if shrink else ''}"
    torch.backends.cudnn.allow_tf32 = True
    evaler = Evaler(dict(data), batch_size=BATCH, img_size=img, half=True, infer_on_rect=rect,
                    shrink_size=shrink, device=dev)
    evaler.init_model(model)
    t0 = time.perf_counter()
    loader = evaler.init_data(None, "val")
    init_s = time.perf_counter() - t0

    # note every launch's path, tiles and K, and every batch shape, of the
    # counted run
    shapes_seen = []
    infer = evaler._infer

    def recording_infer(imgs):
        shapes_seen.append(tuple(imgs.shape[1:3]))
        return infer(imgs)

    evaler._infer = recording_infer
    try:
        with KeepRecorder() as rec:
            greedy_nms.launches = 0
            t0 = time.perf_counter()
            rows = evaler.predict_model(model, loader)
            wall = time.perf_counter() - t0
            launches = greedy_nms.launches
    finally:
        evaler._infer = infer
    n_img = int(evaler.speed_result[0])
    n_batches = len(evaler.batch_split)
    assert n_img == EVAL_SET["n_val"] and n_batches == len(loader)
    assert launches == n_batches, f"{what}: {launches} kernel launches for {n_batches} batches"
    walk = rec.check(what, n_batches * BATCH)
    tiles, ks = walk["tiles_visited"], walk["K"]
    shapes = sorted(set(shapes_seen))
    if rect:
        assert any(s != (img, img) for s in shapes), f"{what}: only {shapes} reached the kernel"
    assert len(rows) > 0, f"{what}: no COCO rows"

    t0 = time.perf_counter()
    ap50, ap = evaler.eval_model(rows, model, loader)
    score_s = time.perf_counter() - t0
    assert all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in (ap50, ap)), (ap50, ap)

    split = split_per_batch(evaler.batch_split)
    fwd_ms, all_ms = evaler.measure_speed(BATCH, iters=10)
    log(f"{tag} eval {what} b{BATCH}@{img} bf16 at the eval protocol: init_data {init_s:.2f} s; "
        f"predict_model {n_img} images in {n_batches} batches {wall:.3f} s = "
        f"{n_img / wall:.1f} imgs/s with the loader; {len(rows)} COCO rows; {launches} kernel "
        f"launches, the tile walk in all {n_img} images, {tiles:.2f} tiles/image; K seen {ks}; "
        f"batch shapes {shapes} [{card}]")
    log(f"{tag} eval {what}: COCO scoring {score_s:.2f} s, AP50 {ap50:.5f}, AP {ap:.5f} (random "
        f"weights); measure_speed fwd+decode {fwd_ms:.4f} ms/img, with NMS {all_ms:.4f} ms/img "
        f"[{card}]")
    out = dict(launches=launches, imgs_per_s=n_img / wall, wall_s=wall, rows=len(rows),
               ap50=ap50, ap=ap, score_s=score_s, tiles_visited=tiles, K=ks,
               shapes=[list(x) for x in shapes], split_per_batch=split,
               speed_fwd_ms_per_img=fwd_ms, speed_all_ms_per_img=all_ms)

    # the device's own busy time over a second pass: CUDA activity only, so
    # that the profiler adds no per-op host cost
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaler.predict_model(model, loader)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if kernels:
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        split["device_ms"] = busy * 1e3 / n_batches
        out["idle"] = 1.0 - busy / prof_wall
        ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
        log(f"{tag} eval {what}, profiled second pass (CUDA activity only): wall {prof_wall:.3f} s "
            f"= {n_img / prof_wall:.1f} imgs/s, kernels and copies {busy * 1e3:.1f} ms, device "
            f"idle {out['idle']:.3f} of the wall time; top: " + "; ".join(
                f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms" for e in ranked[:4])
            + f" [{card}]")
    else:
        split["device_ms"] = out["idle"] = None
        log(f"{tag} eval {what}: the profiler saw no device time; device time and idle share "
            f"not measured")

    # the same loop over batches built beforehand, so that no loader thread
    # runs beside it: does the host's queueing time come from the loader?
    batches = list(loader)
    t0 = time.perf_counter()
    evaler.predict_model(model, batches)
    pre_wall = time.perf_counter() - t0
    del batches
    pre = split_per_batch(evaler.batch_split)
    out["prebuilt"] = dict(imgs_per_s=n_img / pre_wall, wall_s=pre_wall, split_per_batch=pre)
    device = "not measured" if split["device_ms"] is None else f"{split['device_ms']:.3f} ms"
    log(f"{tag} eval {what} per batch (these overlap in the pipeline, their sum is not the wall "
        f"time), with the loader's threads running / over batches built beforehand: loader wait "
        f"{split['loader_ms']:.2f} / {pre['loader_ms']:.2f} ms, host time to queue the batch "
        f"function {split['queue_ms']:.2f} / {pre['queue_ms']:.2f} ms, host-to-device copy "
        f"(CUDA events) {split['h2d_ms']:.3f} / {pre['h2d_ms']:.3f} ms, host conversion to COCO "
        f"rows {split['convert_ms']:.2f} / {pre['convert_ms']:.2f} ms; device kernels and copies "
        f"{device} (profiled pass); predict_model {n_img / wall:.1f} / {n_img / pre_wall:.1f} "
        f"imgs/s [{card}]")

    # the kernel on the counted run's first batch with a candidate, which
    # check() held against the plain emit-once keep
    first = walk["first"]["eval"]
    nms_boxes, scores, idx_k, valid_k = (first[k] for k in ("boxes", "scores", "idx", "valid"))
    md, iou = first["max_det"], first["iou_thres"]
    assert first["emit_once"] and (md, iou) == (evaler.max_det, evaler.iou_thres)
    k_tiles = float(first["tiles"].float().mean())
    ms = cuda_ms(lambda: greedy_nms(nms_boxes, scores, md, iou), iters=20, queue_ahead=True)
    call_ms = cuda_ms(lambda: greedy_nms(nms_boxes, scores, md, iou), iters=20)
    plain_ms = cuda_ms(lambda: greedy_nms_plain(nms_boxes, scores, md, iou), iters=3, warmup=1)
    bound, by = bound_ms(*keep_work_sorted(nms_boxes, scores, idx_k, valid_k, TILE))
    log(f"{tag} greedy_nms on {what}'s first eval batch B={nms_boxes.shape[0]} K={nms_boxes.shape[1]} "
        f"max_det={md}: equal to the plain emit-once keep ({int(valid_k.sum())} kept, "
        f"{k_tiles:.2f} tiles/image); kernel {ms:.4f} ms, per call {call_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({by}) [{card}]")
    out["kernel"] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         tiles_visited=k_tiles, K=int(nms_boxes.shape[1]), max_det=md,
                         max_abs_err=walk["max_abs_err"])
    return out


# the train CLI phase's set: 160 PNG train images beside the eval set, in its
# sizes, from another seed
TRAIN_SET = dict(n_train=160, seed=1, sizes=EVAL_SET["sizes"])
TRAIN_CLI = dict(epochs=2, stop_aug_last_n_epoch=1, workers=8, profiled_steps=3)
# the train CLI's in-training eval threshold, set through the config's
# eval_params: after 3 epochs from random init S scores every anchor below
# the protocol's 0.03, which would leave the kernel no candidate; at 0 every
# one of the 8192 an image passes, as random weights give in phase 11
TRAIN_CLI_EVAL = dict(conf_thres=0.0)
GATE_BAR = dict(min_map50=0.75, min_gain=0.20)


def write_train_split(root: str, card: str) -> str:
    """Phase 12's train split under ``root`` (beside phase 11's val set) and a
    data description naming 80 classes; returns its path."""
    import glob

    from yolov6_tpu_torch.data.synth_detect import CLASS_NAMES, generate_synth_dataset
    from yolov6_tpu_torch.utils.data_config import load_data_config

    t0 = time.perf_counter()
    data = load_data_config(generate_synth_dataset(root, n_val=0, img_size=IMG, **TRAIN_SET))
    secs = time.perf_counter() - t0
    n = len(glob.glob(os.path.join(data["train"], "*.png")))
    assert n == TRAIN_SET["n_train"], n
    assert len(glob.glob(os.path.join(data["val"], "*.png"))) == EVAL_SET["n_val"]
    data["nc"] = NUM_CLASSES
    data["names"] = CLASS_NAMES + [f"class{i}" for i in range(len(CLASS_NAMES), NUM_CLASSES)]
    path = os.path.join(root, "data80.json")
    with open(path, "w") as f:
        json.dump(data, f)
    log(f"[12] wrote {n} PNG train images of (w, h) {TRAIN_SET['sizes']} in {secs:.2f} s beside "
        f"the {EVAL_SET['n_val']} val images [{card}]")
    return path


def augmentation_ms(data_path: str, card: str, n: int = 32) -> dict:
    """The train path's host cost an image on one thread, by branch: the
    whole sample, and within it the C++ pass (mosaic, warp, flips) and the
    numpy HSV pass, over ``n`` samples of the train split at 640."""
    from yolov6_tpu_torch.data import datasets, native_aug
    from yolov6_tpu_torch.data.datasets import TrainValDataset
    from yolov6_tpu_torch.utils.config import Config
    from yolov6_tpu_torch.utils.data_config import load_data_config

    data = load_data_config(data_path)
    hyp = dict(Config.fromfile(os.path.join(ROOT, "configs", "yolov6s.py")).data_aug)
    spent = {"cpp": 0.0, "hsv": 0.0}
    train_aug, hsv = native_aug.train_aug, datasets.augment_hsv_rgb

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapper

    out = {}
    native_aug.train_aug = timed("cpp", train_aug)
    datasets.augment_hsv_rgb = timed("hsv", hsv)
    try:
        for branch, mosaic in (("mosaic", 1.0), ("letterbox", 0.0)):
            ds = TrainValDataset(data["train"], img_size=IMG, batch_size=BATCH, augment=True,
                                 hyp=dict(hyp, mosaic=mosaic), data_dict=dict(data), seed=0)
            spent.update(cpp=0.0, hsv=0.0)
            t0 = time.perf_counter()
            for i in range(n):
                ds[i]
            total = time.perf_counter() - t0
            out[branch] = dict(sample_ms=total / n * 1e3, cpp_ms=spent["cpp"] / n * 1e3,
                               hsv_ms=spent["hsv"] / n * 1e3)
    finally:
        native_aug.train_aug, datasets.augment_hsv_rgb = train_aug, hsv
    log(f"[12] the train path's host ms an image on one thread ({n} samples at {IMG}): " + "; ".join(
        f"{b}: sample {v['sample_ms']:.2f}, C++ pass {v['cpp_ms']:.2f}, HSV pass "
        f"{v['hsv_ms']:.2f}" for b, v in out.items()) + f" [{card}]")
    return out


def train_cli_phase(data_path: str, root: str, dev, card: str) -> dict:
    """Phase 12 (see the module doc); returns its numbers."""
    import torch

    from yolov6_tpu_torch.core.engine import Trainer
    from yolov6_tpu_torch.tools import train as train_cli
    from yolov6_tpu_torch.utils.checkpoint import load_checkpoint, load_state_dict_file
    from yolov6_tpu_torch.utils.config import Config
    from yolov6_tpu_torch.utils.events import load_yaml, save_yaml

    t = TRAIN_CLI
    conf_file = os.path.join(root, "yolov6s_train_cli.py")
    with open(os.path.join(ROOT, "configs", "yolov6s.py")) as f:
        text = f.read()
    with open(conf_file, "w") as f:
        f.write(f"{text}\neval_params = {TRAIN_CLI_EVAL!r}\n")
    argv = ["--data-path", data_path, "--conf-file", conf_file,
            "--img-size", str(IMG), "--batch-size", str(BATCH), "--epochs", str(t["epochs"]),
            "--workers", str(t["workers"]), "--eval-final-only",
            "--stop_aug_last_n_epoch", str(t["stop_aug_last_n_epoch"]),
            "--save_ckpt_on_last_n_epoch", "1", "--output-dir", os.path.join(root, "train"),
            "--name", "s", "--bf16", "--profile", "--log-interval", "5", "--seed", "0",
            "--device", "cuda"]
    args = train_cli.get_args_parser().parse_args(argv)
    with KeepRecorder() as rec:
        t0 = time.perf_counter()
        trainer = train_cli.main(args)
        wall = time.perf_counter() - t0
    weights = os.path.join(args.save_dir, "weights")
    n_val = EVAL_SET["n_val"]
    walk = rec.check("[12] in-training eval", n_val)
    first = walk["first"]["eval"]
    n_eval_batches = -(-n_val // BATCH)
    assert walk["launches"] == n_eval_batches, f"{walk['launches']} launches, {n_eval_batches} batches"
    assert len(trainer.eval_stats) == 1 and trainer.eval_stats[0]["images"] == n_val
    for name in ("last_ckpt", "best_ckpt", f"{t['epochs'] - 1}_ckpt"):
        assert os.path.exists(os.path.join(weights, f"{name}.pt")), f"no {name}.pt"
    stats = trainer.epoch_stats
    assert [e["epoch"] for e in stats] == list(range(t["epochs"]))
    assert all(math.isfinite(v) for e in stats for v in e["mean_loss"]), stats
    assert stats[0]["steps"] == TRAIN_SET["n_train"] // BATCH
    for e in stats:
        log(f"[12] train CLI S epoch {e['epoch']} ({'mosaic' if e['epoch'] == 0 else 'letterbox'}"
            f"+affine): {e['steps']} steps of b{BATCH}@{IMG} bf16 in {e['wall_s']:.3f} s = "
            f"{e['imgs_per_s']:.1f} imgs/s with the loader (host clock); loader wait "
            f"{e['loader_wait_s'] / e['steps'] * 1e3:.2f} ms a step; step {e['step_ms']:.3f} ms "
            f"(CUDA events, from queueing to the end: the device time plus any gap the host "
            f"leaves); mean loss [iou, dfl, cls] {[round(v, 5) for v in e['mean_loss']]} [{card}]")
    prof = trainer.profile_result
    if prof and prof["idle"] is not None:
        log(f"[12] profiled {prof['steps']} steps of epoch 0: window {prof['wall_s']:.3f} s, device "
            f"busy {prof['device_busy_s']:.3f} s, idle {prof['idle']:.3f} of the window; top: "
            + "; ".join(f"{k} {ms:.1f} ms/step" for k, ms in prof["top"][:4]) + f" [{card}]")
    else:
        log("[12] the profiler saw no device time; the idle share is not measured")
    ev = trainer.eval_stats[0]
    log(f"[12] in-training eval of the EMA (train form, eval mode) at epoch {ev['epoch']}, "
        f"conf {TRAIN_CLI_EVAL['conf_thres']}: {ev['images']} images in {ev['batches']} batches, "
        f"{ev['predict_s']:.3f} s = {ev['imgs_per_s']:.1f} imgs/s; {walk['launches']} kernel "
        f"launches, the tile walk in every image ({walk['tiles_visited']:.2f} tiles/image), "
        f"the first batch's keep (B={first['boxes'].shape[0]} K={first['boxes'].shape[1]}, "
        f"{first['kept']} kept) equal to the plain emit-once keep; AP50 {ev['ap50']:.5f}, AP "
        f"{ev['ap']:.5f}; the whole CLI run {wall:.1f} s [{card}]")

    # resume: the run's args.yaml, extended to a third epoch, wins over the
    # command line; the last_ckpt of the finished run was stripped, so the
    # run continues from its unstripped checkpoint of the same epoch
    args_yaml = os.path.join(args.save_dir, "args.yaml")
    save_yaml(dict(load_yaml(args_yaml), epochs=t["epochs"] + 1), args_yaml)
    saved = load_checkpoint(os.path.join(weights, f"{t['epochs'] - 1}_ckpt.pt"))
    rargs = train_cli.get_args_parser().parse_args(
        ["--resume", os.path.join(weights, f"{t['epochs'] - 1}_ckpt.pt"), "--epochs", "99",
         "--device", "cuda"])
    with KeepRecorder() as rec2:
        t0 = time.perf_counter()
        # tools/train.py::main, with the resumed state checked before training
        cfg = train_cli.check_and_init(rargs)
        assert rargs.epochs == t["epochs"] + 1, "the saved args.yaml did not win"
        resumed = Trainer(rargs, cfg)
        assert resumed.start_epoch == t["epochs"], resumed.start_epoch
        state = resumed.train_step.state_dict()
        assert all(torch.equal(state[k], saved["train_state"][k]) for k in state),             "the resumed step's state differs from the saved one"
        resumed.train()
        rwall = time.perf_counter() - t0
    rstats = resumed.epoch_stats
    assert [e["epoch"] for e in rstats] == [t["epochs"]], rstats
    assert all(math.isfinite(v) for v in rstats[0]["mean_loss"])
    rwalk = rec2.check("[12] resumed run's eval", n_val)
    model = load_state_dict_file(os.path.join(weights, "last_ckpt.pt"),
                                 Config.fromfile(os.path.join(ROOT, "configs", "yolov6s.py")),
                                 device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[12] resumed at epoch {resumed.start_epoch} with the step's state equal to the saved "
        f"one; epoch {rstats[0]['epoch']}: {rstats[0]['imgs_per_s']:.1f} imgs/s, mean loss "
        f"{[round(v, 5) for v in rstats[0]['mean_loss']]}; run {rwall:.1f} s; the stripped final "
        f"checkpoint folded into the deploy graph ({n_params / 1e6:.2f} M params, strict) "
        f"[{card}]")
    return dict(launches=walk["launches"], epochs=stats + rstats, eval=trainer.eval_stats,
                profile=prof, tiles_visited=walk["tiles_visited"], wall_s=wall,
                resume_wall_s=rwall, max_abs_err=max(walk["max_abs_err"], rwalk["max_abs_err"]))


def learning_gate_phase(root: str, card: str) -> dict:
    """Phase 13: ``tools/learning_gate.py`` at its defaults on the card."""
    from yolov6_tpu_torch.tools import learning_gate

    args = learning_gate.get_args_parser().parse_args(["--out", os.path.join(root, "gate")])
    eval_ckpt = learning_gate._eval_ckpt

    def labelled_eval(*a, **kw):
        # the checkpoint evals, at the default NMS and at the exact NMS
        rec.label = "exact" if kw.get("max_nms") == 30000 else "default"
        return eval_ckpt(*a, **kw)

    learning_gate._eval_ckpt = labelled_eval
    try:
        with KeepRecorder("in-training") as rec:
            t0 = time.perf_counter()
            rc = learning_gate.main(args)
            wall = time.perf_counter() - t0
    finally:
        learning_gate._eval_ckpt = eval_ckpt
    with open(os.path.join(args.out, "gate_result.json")) as f:
        result = json.load(f)
    walk = rec.check("[13] gate evals", args.n_val, labels=("in-training", "default", "exact"))
    firsts = "; ".join(f"{k} B={f['boxes'].shape[0]} K={f['boxes'].shape[1]} {f['kept']} kept"
                       for k, f in walk["first"].items())
    traj = [(p["epoch"], round(p["map50"], 4), round(p["map50_95"], 4))
            for p in result["trajectory"]]
    log(f"[13] learning gate (N, {args.img_size} px, {args.n_train}/{args.n_val} images, "
        f"{args.epochs} epochs, batch {args.batch_size}, seed {args.seed}): trajectory (epoch, "
        f"mAP50, mAP50-95) {traj}; gain {result['gain']:.4f}; exact NMS mAP50 "
        f"{result['exact_nms']['map50']:.4f}, mAP50-95 {result['exact_nms']['map50_95']:.4f}, "
        f"delta mAP50-95 {result['nms_delta_map50_95']:+.4f}; training {result['train_s']:.1f} s, "
        f"gate {wall:.1f} s; {walk['launches']} kernel launches in its evals, the tile walk in "
        f"every image ({walk['tiles_visited']:.2f} tiles/image), the first batch's keep with a "
        f"candidate equal to the plain emit-once keep in each pass ({firsts}) [{card}]")
    assert rc == 0 and result["passed"], f"the learning gate failed: {result}"
    assert result["final_map50"] > GATE_BAR["min_map50"] and result["gain"] > GATE_BAR["min_gain"]
    return dict(launches=walk["launches"], wall_s=wall, tiles_visited=walk["tiles_visited"],
                max_abs_err=walk["max_abs_err"], **{
        k: result[k] for k in ("trajectory", "final_map50", "gain", "exact_nms",
                               "nms_delta_map50_95", "train_s")})


def distill_gate_phase(root: str, card: str) -> dict:
    """Phase 17: ``tools/learning_gate.py --distill`` at its defaults on the
    card; the launches of the teacher stage and of the rest are counted
    apart."""
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.tools import learning_gate

    args = learning_gate.get_args_parser().parse_args(
        ["--out", os.path.join(root, "distill_gate"), "--distill",
         "--teacher-epochs", str(DISTILL_GATE_TEACHER_EPOCHS)])
    eval_ckpt, prestage = learning_gate._eval_ckpt, learning_gate._distill_prestage
    counts = {}

    def labelled_eval(*a, **kw):
        rec.label = "exact" if kw.get("max_nms") == 30000 else "default"
        return eval_ckpt(*a, **kw)

    def labelled_prestage(*a, **kw):
        # the teacher's in-training eval, then the student's
        out = prestage(*a, **kw)
        counts["teacher"] = greedy_nms.launches
        rec.label = "in-training"
        return out

    learning_gate._eval_ckpt, learning_gate._distill_prestage = labelled_eval, labelled_prestage
    try:
        with KeepRecorder("teacher") as rec:
            greedy_nms.launches = 0
            t0 = time.perf_counter()
            rc = learning_gate.main(args)
            wall = time.perf_counter() - t0
            counts["student"] = greedy_nms.launches - counts["teacher"]
    finally:
        learning_gate._eval_ckpt, learning_gate._distill_prestage = eval_ckpt, prestage
    with open(os.path.join(args.out, "gate_result.json")) as f:
        result = json.load(f)
    labels = ("teacher", "in-training", "default", "exact")
    walk = rec.check("[17] distill gate evals", args.n_val, labels=labels)
    firsts = "; ".join(f"{k} B={f['boxes'].shape[0]} K={f['boxes'].shape[1]} {f['kept']} kept"
                       for k, f in walk["first"].items())
    teacher = result["teacher"]
    traj = [(p["epoch"], round(p["map50"], 4), round(p["map50_95"], 4))
            for p in result["trajectory"]]
    log(f"[17] distill learning gate (N, {args.img_size} px, {args.n_train}/{args.n_val} "
        f"images, {args.epochs} epochs, batch {args.batch_size}, seed {args.seed}): the fuse-AB "
        f"teacher (DFL config, {args.teacher_epochs or args.epochs} epochs) trained in "
        f"{teacher['train_s']:.1f} s, its final in-training "
        f"mAP50 {teacher['final_map50']:.4f}; the distill-NS student's trajectory (epoch, "
        f"mAP50, mAP50-95) {traj} with the original config; gain {result['gain']:.4f}; exact "
        f"NMS mAP50 {result['exact_nms']['map50']:.4f}, delta mAP50-95 "
        f"{result['nms_delta_map50_95']:+.4f}; student training {result['train_s']:.1f} s, gate "
        f"{wall:.1f} s; kernel launches: {counts['teacher']} in the teacher's eval, "
        f"{counts['student']} in the student's evals, the tile walk in every image "
        f"({walk['tiles_visited']:.2f} tiles/image), the first keep with a candidate equal to "
        f"the plain emit-once keep in each pass ({firsts}) [{card}]")
    assert rc == 0 and result["passed"], f"the distill learning gate failed: {result}"
    assert result["final_map50"] > GATE_BAR["min_map50"] and result["gain"] > GATE_BAR["min_gain"]
    return dict(launches=walk["launches"], teacher_launches=counts["teacher"],
                student_launches=counts["student"], wall_s=wall,
                tiles_visited=walk["tiles_visited"], max_abs_err=walk["max_abs_err"],
                teacher_final_map50=teacher["final_map50"], teacher_train_s=teacher["train_s"],
                **{k: result[k] for k in ("trajectory", "final_map50", "gain", "exact_nms",
                                          "nms_delta_map50_95", "train_s")})


def recipe_phases(cfgs, images, dev, card: str) -> dict:
    """Phases 14-16: the training recipes' steps at full width, and the
    folded serve of the fuse-AB and distill-NS students."""
    import torch

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.utils.config import Config

    out = {}
    greedy_nms.launches = 0
    step, out["train_fuse_ab"] = train_phase(cfgs["s"], "YOLOv6-S fuse-AB", dev, card, "[14]",
                                             TRAIN["timed_steps"], profile=False,
                                             recipe="fuse_ab")
    out["train_fuse_ab"]["launches"] = greedy_nms.launches
    out["fuse_ab_fold_serve"] = fold_and_serve_phase(cfgs["s"], "YOLOv6-S fuse-AB", step, images,
                                                     dev, card, "[14]")
    del step
    torch.cuda.empty_cache()

    dfl_s = Config.fromfile(os.path.join(ROOT, "configs", "yolov6s.py"))
    dfl_s.model.head.use_dfl, dfl_s.model.head.reg_max = True, 16
    greedy_nms.launches = 0
    step, out["train_distill_ns"] = train_phase(dfl_s, "YOLOv6-S distill-NS", dev, card, "[15]",
                                                TRAIN["timed_steps"], profile=False,
                                                recipe="distill")
    out["train_distill_ns"]["launches"] = greedy_nms.launches
    # the student ships its plain ltrb branch: folded with the original config
    out["distill_ns_fold_serve"] = fold_and_serve_phase(cfgs["s"], "YOLOv6-S distill-NS", step,
                                                        images, dev, card, "[15]")
    del step
    torch.cuda.empty_cache()

    greedy_nms.launches = 0
    step, out["train_m_kd"] = train_phase(cfgs["m"], "YOLOv6-M KD", dev, card, "[16]",
                                          M_KD_TIMED_STEPS, profile=False, recipe="distill")
    out["train_m_kd"]["launches"] = greedy_nms.launches
    del step
    torch.cuda.empty_cache()
    return out


def p6_images(dev, seed: int = 0):
    """b32 random uint8 NHWC images at ``P6_IMG``, drawn on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (BATCH, P6_IMG, P6_IMG, 3), generator=gen, device=dev,
                         dtype=torch.uint8)


def timed_serve_phase(cfg, label: str, model, images, dev, card: str, tag: str,
                      cpu_decode: bool = False, profile: bool = False) -> dict:
    """Phases 18 and 21: ``model`` serves ``images`` in bf16 through
    ``make_end2end_fn`` at the serving defaults; the first call's keep with a
    candidate must equal the plain emit-once keep; then ``time_serve`` (with
    a profile of 3 calls when ``profile``), and the kernel timed on those
    served candidates against its plain version and its bound. With
    ``cpu_decode`` the fp32 decode of two images on the CPU is held against
    the CUDA one (TF32 off), as in phase 3. Returns the numbers."""
    import torch

    from yolov6_tpu_torch.models.end2end import make_end2end_fn
    from yolov6_tpu_torch.models.yolo import build_model
    from yolov6_tpu_torch.ops.cuda.nms_kernel import TILE, greedy_nms, greedy_nms_plain

    torch.backends.cudnn.allow_tf32 = True
    serve16 = make_end2end_fn(model, **SERVE, with_preprocess=True, half=True, device=dev)
    with KeepRecorder("serve") as rec:
        serve16(images)
        torch.cuda.synchronize()
    walk = rec.check(f"{tag} {label} serve", images.shape[0], labels=("serve",))
    first = walk["first"]["serve"]
    out = time_serve(model, label, images, dev, card, tag, profile_tag=tag if profile else None)

    nms_boxes, cand_scores, idx_k, valid_k = (first[k] for k in ("boxes", "scores", "idx",
                                                                  "valid"))
    md, iou = first["max_det"], first["iou_thres"]
    ms = cuda_ms(lambda: greedy_nms(nms_boxes, cand_scores, md, iou), iters=20, queue_ahead=True)
    call_ms = cuda_ms(lambda: greedy_nms(nms_boxes, cand_scores, md, iou), iters=20)
    plain_ms = cuda_ms(lambda: greedy_nms_plain(nms_boxes, cand_scores, md, iou), iters=3,
                       warmup=1)
    bound, by = bound_ms(*keep_work_sorted(nms_boxes, cand_scores, idx_k, valid_k, TILE))
    tiles = float(first["tiles"].float().mean())
    out.update(params=sum(p.numel() for p in model.parameters()), ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by, K=int(nms_boxes.shape[1]),
               max_det=md, tiles_visited=tiles, max_abs_err=walk["max_abs_err"])
    log(f"{tag} greedy_nms on {label}'s served candidates B={nms_boxes.shape[0]} K={out['K']} "
        f"max_det={md}: equal to the plain emit-once keep ({int(valid_k.sum())} kept, "
        f"{tiles:.2f} tiles/image); kernel {ms:.4f} ms, per call {call_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({by}) [{card}]")

    if cpu_decode:
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            cpu_model = build_model(cfg, num_classes=NUM_CLASSES, deploy=True, device="cpu")
            cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
            with torch.inference_mode():
                preds_gpu = forward_decode(images[:2], model, half=False).cpu()
                preds_cpu = forward_decode(images[:2].cpu(), cpu_model, half=False)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.testing.assert_close(preds_cpu[..., :4], preds_gpu[..., :4], **DECODE_BOX_TOL)
        torch.testing.assert_close(preds_cpu[..., 4:], preds_gpu[..., 4:], **DECODE_SCORE_TOL)
        out["decode_box_err"] = float((preds_cpu[..., :4] - preds_gpu[..., :4]).abs().max())
        out["decode_score_err"] = float((preds_cpu[..., 4:] - preds_gpu[..., 4:]).abs().max())
        log(f"{tag} {label} fp32 decode of 2 images at {images.shape[1]}, CPU vs CUDA (TF32 "
            f"off): max |box| diff {out['decode_box_err']:.3e} px, max |score| diff "
            f"{out['decode_score_err']:.3e} (tolerance boxes {DECODE_BOX_TOL}, scores "
            f"{DECODE_SCORE_TOL})")
    return out


def p6_serve_phases(cfgs, dev, card: str) -> dict:
    """Phase 18: N6, S6, M6 and L6 deploy graphs serve b32@1280 in bf16 at the
    serving defaults, K = 30,000 NMS candidates an image."""
    import torch

    images = p6_images(dev)
    out = {}
    for i, name in enumerate(P6_NAMES):
        model = deploy_model(cfgs[name], 10 + i, dev)
        out[name] = timed_serve_phase(cfgs[name], f"YOLOv6-{name.upper()}", model, images, dev,
                                      card, "[18]", cpu_decode=name == "n6",
                                      profile=name == "l6")
        assert out[name]["K"] == P6_SERVE_K, out[name]["K"]
        del model
        torch.cuda.empty_cache()
    return out


def l6_batch(cfg, dev, card: str) -> int:
    """Phase 19's L6 batch: two steps at the smallest of ``L6_BATCHES`` give
    the peak; the memory the step holds between steps (weights, gradients,
    momentum, EMA) plus the rest scaled by the batch predicts the others'."""
    import torch

    from yolov6_tpu_torch.core.train_step import make_train_step
    from yolov6_tpu_torch.solver.build import scale_hyperparams_for_batch

    probe = min(L6_BATCHES)
    model, loss_fn, _ = recipe_step(cfg, None, dev, torch.Generator(device=dev).manual_seed(0),
                                    TRAIN["epochs"], P6_IMG)
    solver = scale_hyperparams_for_batch(dict(cfg.solver), probe)
    step = make_train_step(model, loss_fn, solver, TRAIN["max_stepnum"], TRAIN["epochs"], probe,
                           TRAIN["warmup_stepnum"], (P6_IMG, P6_IMG), half=True, device=dev)
    images, targets = bench_batch(probe, P6_IMG, TRAIN["max_labels"], TRAIN["labels"], dev)
    step(images, targets, TRAIN["epoch"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(images, targets, TRAIN["epoch"])
    torch.cuda.synchronize()
    peak, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    del step, model, images, targets
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    per_image = (peak - held) / probe
    predicted = {b: held + b * per_image for b in L6_BATCHES}
    batch = max(b for b in L6_BATCHES
                if b == probe or predicted[b] <= (1 - L6_FREE_SHARE) * total)
    log(f"[19] L6 memory probe at b{probe}@{P6_IMG}: peak {peak / 2**30:.2f} GiB, held between "
        f"steps {held / 2**30:.2f} GiB; predicted peaks " + ", ".join(
            f"b{b} {v / 2**30:.2f} GiB" for b, v in predicted.items())
        + f" of {total / 2**30:.2f} GiB; L6 trains at b{batch} [{card}]")
    return batch


def p6_train_phases(cfgs, dev, card: str) -> dict:
    """Phase 19: S6 (TAL, no DFL) at b32@1280 and L6 (DFL, conv_silu) at the
    batch ``l6_batch`` picks, on the bench's data at epoch 100 of 300, then 3
    ATSS steps; each trained model and its EMA folded and served at conf
    0.001 through the kernel."""
    import torch

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms

    images = p6_images(dev, seed=1)
    total = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for name in ("s6", "l6"):
        batch = BATCH if name == "s6" else l6_batch(cfgs[name], dev, card)
        greedy_nms.launches = 0
        step, out[f"train_{name}"] = train_phase(
            cfgs[name], f"YOLOv6-{name.upper()}", dev, card, "[19]", P6_TIMED_STEPS,
            profile=False, atss_steps=ATSS_STEPS, batch=batch, img=P6_IMG)
        out[f"train_{name}"]["launches"] = greedy_nms.launches
        if name == "l6":
            peak = out["train_l6"]["peak_gib"] * 2**30
            assert peak <= (1 - L6_FREE_SHARE) * total, \
                f"L6 b{batch} peaked at {peak / 2**30:.2f} GiB of {total / 2**30:.2f}"
        torch.cuda.empty_cache()
        out[f"{name}_fold_serve"] = fold_and_serve_phase(
            cfgs[name], f"YOLOv6-{name.upper()}", step, images, dev, card, "[19]")
        del step
        torch.cuda.empty_cache()
    return out


def mbla_phases(dev, card: str, images) -> dict:
    """Phase 21: X-MBLA's deploy graph serves b32@640 in bf16; S-MBLA's
    training step at b32@640 (DFL, TAL), 20 timed steps; S-MBLA folded and
    served at conf 0.001 through the kernel."""
    import torch

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.utils.config import Config

    cfgs = {k: Config.fromfile(os.path.join(ROOT, "configs", "mbla", f"yolov6{k}_mbla.py"))
            for k in ("s", "x")}
    out = {}
    model = deploy_model(cfgs["x"], 20, dev)
    out["serve_x"] = timed_serve_phase(cfgs["x"], "YOLOv6-X-MBLA", model, images, dev, card,
                                       "[21]")
    del model
    torch.cuda.empty_cache()
    greedy_nms.launches = 0
    step, out["train_s"] = train_phase(cfgs["s"], "YOLOv6-S-MBLA", dev, card, "[21]",
                                       TRAIN["timed_steps"], profile=False)
    out["train_s"]["launches"] = greedy_nms.launches
    out["s_fold_serve"] = fold_and_serve_phase(cfgs["s"], "YOLOv6-S-MBLA", step, images, dev,
                                               card, "[21]")
    del step
    torch.cuda.empty_cache()
    return out


def train_subset(root: str, n_train: int) -> str:
    """A data description whose train split is the first ``n_train`` images
    of phase 12's (copied once, with their labels); returns its path."""
    import glob
    import shutil

    from yolov6_tpu_torch.utils.data_config import load_data_config

    data_path = os.path.join(root, f"data80_train{n_train}.json")
    if os.path.exists(data_path):
        return data_path
    data = load_data_config(os.path.join(root, "data80.json"))
    sub = f"train{n_train}"
    for kind in ("images", "labels"):
        os.makedirs(os.path.join(root, kind, sub))
    for path in sorted(glob.glob(os.path.join(data["train"], "*.png")))[:n_train]:
        stem = os.path.splitext(os.path.basename(path))[0]
        shutil.copy(path, os.path.join(root, "images", sub))
        shutil.copy(os.path.join(root, "labels", "train", f"{stem}.txt"),
                    os.path.join(root, "labels", sub))
    data["train"] = os.path.join(root, "images", sub)
    with open(data_path, "w") as f:
        json.dump(data, f)
    return data_path


def p6_train_cli_phase(root: str, dev, card: str) -> dict:
    """Phase 22: N6 through ``tools/train.py`` at 1280, batch 8, 2 epochs over
    the first 64 images of phase 12's split (both epochs on ATSS, the first
    on the mosaic branch), with one in-training eval of the 160 val images at
    conf 0 (through the config's eval_params, as phase 12); its first keep
    with a candidate held against the plain emit-once keep."""
    from yolov6_tpu_torch.tools import train as train_cli

    t = P6_TRAIN_CLI
    data_path = train_subset(root, t["n_train"])
    conf_file = os.path.join(root, "yolov6n6_train_cli.py")
    with open(os.path.join(ROOT, "configs", "yolov6n6.py")) as f:
        text = f.read()
    with open(conf_file, "w") as f:
        f.write(f"{text}\neval_params = {TRAIN_CLI_EVAL!r}\n")
    argv = ["--data-path", data_path, "--conf-file", conf_file, "--img-size", str(P6_IMG),
            "--batch-size", str(t["batch"]), "--epochs", str(t["epochs"]),
            "--workers", str(t["workers"]), "--eval-final-only",
            "--stop_aug_last_n_epoch", str(t["stop_aug_last_n_epoch"]),
            "--output-dir", os.path.join(root, "train"), "--name", "n6", "--bf16",
            "--log-interval", "4", "--seed", "0", "--device", "cuda"]
    args = train_cli.get_args_parser().parse_args(argv)
    with KeepRecorder() as rec:
        t0 = time.perf_counter()
        trainer = train_cli.main(args)
        wall = time.perf_counter() - t0
    n_val = EVAL_SET["n_val"]
    walk = rec.check("[22] N6 in-training eval", n_val)
    first = walk["first"]["eval"]
    assert walk["launches"] == -(-n_val // t["batch"]), walk["launches"]
    assert trainer.atss_warmup_epoch > t["epochs"] - 1 and trainer.model.strides[-1] == 64
    stats = trainer.epoch_stats
    assert [e["epoch"] for e in stats] == list(range(t["epochs"]))
    assert all(math.isfinite(v) for e in stats for v in e["mean_loss"]), stats
    assert stats[0]["steps"] == t["n_train"] // t["batch"]
    for e in stats:
        log(f"[22] train CLI N6 epoch {e['epoch']} ({'mosaic' if e['epoch'] == 0 else 'letterbox'}"
            f"+affine, ATSS): {e['steps']} steps of b{t['batch']}@{P6_IMG} bf16 in "
            f"{e['wall_s']:.3f} s = {e['imgs_per_s']:.1f} imgs/s with the loader (host clock); "
            f"loader wait {e['loader_wait_s'] / e['steps'] * 1e3:.2f} ms a step; step "
            f"{e['step_ms']:.3f} ms (CUDA events); mean loss [iou, dfl, cls] "
            f"{[round(v, 5) for v in e['mean_loss']]} [{card}]")
    ev = trainer.eval_stats[0]
    log(f"[22] in-training eval of N6's EMA at {P6_IMG}, conf {TRAIN_CLI_EVAL['conf_thres']}: "
        f"{ev['images']} images in {ev['batches']} batches, {ev['predict_s']:.3f} s = "
        f"{ev['imgs_per_s']:.1f} imgs/s; {walk['launches']} kernel launches, the tile walk in "
        f"every image ({walk['tiles_visited']:.2f} tiles/image), the first batch's keep "
        f"(B={first['boxes'].shape[0]} K={first['boxes'].shape[1]}, {first['kept']} kept) equal "
        f"to the plain emit-once keep; AP50 {ev['ap50']:.5f}; the whole CLI run {wall:.1f} s "
        f"[{card}]")
    return dict(launches=walk["launches"], epochs=stats, eval=trainer.eval_stats,
                tiles_visited=walk["tiles_visited"], wall_s=wall,
                max_abs_err=walk["max_abs_err"])


class StepTimer:
    """Times, while active, the steps of the inferer's per-image loop as the
    infer CLI runs them (host clock): decode (``LoadData``'s ``imread``),
    letterbox (``process_image``), device (the infer function, synchronised:
    the loop's copy of the detections to the host waits for it anyway),
    draw (``plot_box_and_label``), write (``imwrite_png``) and the whole
    loop (``Inferer.infer``; the rest of it is the rescale and the label
    rows)."""

    STEPS = ("decode", "letterbox", "device", "draw", "write", "loop")

    def __init__(self):
        from yolov6_tpu_torch.core import inferer as inferer_mod
        from yolov6_tpu_torch.data import datasets

        self.inferer_mod, self.datasets = inferer_mod, datasets
        self.s = dict.fromkeys(self.STEPS, 0.0)

    def _timed(self, step, fn, sync=False):
        import torch

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            self.s[step] += time.perf_counter() - t0
            return out

        return timed

    def __enter__(self):
        mod, datasets = self.inferer_mod, self.datasets
        cls = mod.Inferer
        self.saved = [(datasets, "imread", datasets.imread),
                      (mod, "imwrite_png", mod.imwrite_png),
                      (mod, "make_infer_fn", mod.make_infer_fn),
                      (cls, "process_image", cls.process_image),
                      (cls, "plot_box_and_label", cls.__dict__["plot_box_and_label"]),
                      (cls, "infer", cls.infer)]
        make = mod.make_infer_fn
        datasets.imread = self._timed("decode", datasets.imread)
        mod.imwrite_png = self._timed("write", mod.imwrite_png)
        mod.make_infer_fn = lambda *a, **kw: self._timed("device", make(*a, **kw), sync=True)
        cls.process_image = self._timed("letterbox", cls.process_image)
        cls.plot_box_and_label = staticmethod(self._timed("draw", cls.plot_box_and_label))
        cls.infer = self._timed("loop", cls.infer)
        return self

    def __exit__(self, *exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)


def infer_phase(root: str, dev, card: str) -> dict:
    """Phase 23: the demo JPEGs decode to cv2's pixels (sha256); the infer
    CLI (``tools/infer.py::run``, in-process) on full-width S with seeded
    weights over data/images at its defaults, in fp32 and bf16 (``--half``),
    then with ``--classes 0 2`` and with ``--agnostic-nms``: every image's
    keep (B=1, K=2000 filled, max_det 1000) equal to the plain keep, a PNG at
    the source's size and a label row for each detection; the steps of the
    loop timed on a second run of each precision; then the learning gate's
    N on its val images, whose detections must find most GT boxes."""
    import glob
    import hashlib
    import statistics

    import numpy as np
    import torch

    from yolov6_tpu_torch.data.image_io import imread
    from yolov6_tpu_torch.ops.cuda.nms_kernel import TILE, greedy_nms, greedy_nms_plain
    from yolov6_tpu_torch.tools import infer as infer_cli
    from yolov6_tpu_torch.utils.config import Config

    decode_ms = {}
    for name, (shape, digest) in DEMO_JPEGS.items():
        path = os.path.join(ROOT, name)
        img = imread(path)
        assert img.shape == shape, f"{name}: decoded to {img.shape}, cv2 gives {shape}"
        assert hashlib.sha256(img.tobytes()).hexdigest() == digest, \
            f"{name}: the decode differs from cv2.imread's"
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            imread(path)
            times.append((time.perf_counter() - t0) * 1e3)
        decode_ms[name] = statistics.median(times)
    log("[23] the demo JPEGs decode to cv2.imread's pixels (sha256); host decode, median of 7: "
        + ", ".join(f"{os.path.basename(n)} {DEMO_JPEGS[n][0][1]}x{DEMO_JPEGS[n][0][0]} "
                    f"{ms:.2f} ms" for n, ms in decode_ms.items()) + f" [{card}]")

    cfg_path = os.path.join(ROOT, "configs", "yolov6s.py")
    model = deploy_model(Config.fromfile(cfg_path), 0, dev)
    weights = os.path.join(root, "infer_s.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, weights)
    del model
    source = os.path.join(ROOT, "data", "images")
    stems = [os.path.splitext(os.path.basename(n))[0] for n in sorted(DEMO_JPEGS)]
    src_shapes = [DEMO_JPEGS[n][0] for n in sorted(DEMO_JPEGS)]

    def cli(name, *extra, timed=False):
        out = os.path.join(root, "infer", name)
        args = infer_cli.get_args_parser().parse_args([
            "--weights", weights, "--config", cfg_path, "--source", source, "--save-txt",
            "--save-dir", out, "--device", "cuda", *extra])
        assert (args.conf_thres, args.iou_thres, args.max_det) == (
            INFER_CLI["conf_thres"], INFER_CLI["iou_thres"], INFER_CLI["max_det"])
        with KeepRecorder(record_all=not timed) as rec, StepTimer() as timer:
            infer_cli.run(args)
        res = dict(launches=len(rec.walks), steps_ms={
            k: v * 1e3 / len(stems) for k, v in timer.s.items()},
            imgs_per_s=len(stems) / timer.s["loop"])
        if timed:
            return res
        launches, res["max_abs_err"] = rec.check_all(f"[23] infer {name}")
        assert len(launches) == len(stems), f"[23] {name}: {len(launches)} keeps for 3 images"
        res["kept"], res["pos"] = [], []
        for stem, shape, f in zip(stems, src_shapes, launches):
            assert f["boxes"].shape == (1, INFER_CLI["max_nms"], 4) and f["max_det"] == \
                INFER_CLI["max_det"] and f["emit_once"]
            n_pos, kept = int((f["scores"] > 0).sum()), int(f["valid"].sum())
            assert n_pos == INFER_CLI["max_nms"], f"[23] {name} {stem}: {n_pos} candidates"
            drawn = imread(os.path.join(out, "images", f"{stem}.png"))
            assert drawn.shape == shape, f"[23] {name} {stem}: PNG {drawn.shape}, source {shape}"
            with open(os.path.join(out, "images", "labels", f"{stem}.txt")) as fh:
                rows = [list(map(float, line.split())) for line in fh]
            assert len(rows) == kept > 0 and all(len(r) == 6 for r in rows)
            if "--classes" in extra:
                assert {int(r[0]) for r in rows} <= {0, 2}, f"[23] {name}: classes outside 0, 2"
            res["kept"].append(kept)
            res["pos"].append(n_pos)
        res["first"] = launches[0]
        return res

    runs = {"fp32": cli("fp32"), "fp32_timed": cli("fp32_timed", timed=True),
            "half": cli("half", "--half"), "half_timed": cli("half_timed", "--half", timed=True),
            "classes": cli("classes", "--classes", "0", "2"),
            "agnostic": cli("agnostic", "--agnostic-nms")}
    for name in ("fp32", "half", "classes", "agnostic"):
        r = runs[name]
        log(f"[23] infer CLI {name} (YOLOv6-S, 640, conf {INFER_CLI['conf_thres']}, IoU "
            f"{INFER_CLI['iou_thres']}, max_det {INFER_CLI['max_det']}) over data/images: "
            f"{r['launches']} kernel launches (B=1 each), K {r['pos']} candidates an image "
            f"(the cap), {r['kept']} kept, each keep equal to the plain emit-once keep; a PNG at "
            f"the source size and a label row a detection for each image [{card}]")
    for name in ("fp32_timed", "half_timed"):
        r = runs[name]
        log(f"[23] infer CLI {name[:-6]}, second run: {r['imgs_per_s']:.2f} imgs/s; ms an image: "
            + ", ".join(f"{k} {v:.2f}" for k, v in r["steps_ms"].items())
            + f" (host clock) [{card}]")

    # the kernel on the fp32 run's first image's candidates; these launches
    # time it and are not the path's, so the count is put back after them
    n_path = greedy_nms.launches
    f = runs["fp32"]["first"]
    boxes, scores, idx_k, valid_k = f["boxes"], f["scores"], f["idx"], f["valid"]
    md, iou = f["max_det"], f["iou_thres"]
    ms = cuda_ms(lambda: greedy_nms(boxes, scores, md, iou), iters=20, queue_ahead=True)
    call_ms = cuda_ms(lambda: greedy_nms(boxes, scores, md, iou), iters=20)
    plain_ms = cuda_ms(lambda: greedy_nms_plain(boxes, scores, md, iou), iters=3, warmup=1)
    bound, by = bound_ms(*keep_work_sorted(boxes, scores, idx_k, valid_k, TILE))
    tiles = float(f["tiles"].float().mean())
    greedy_nms.launches = n_path
    log(f"[23] greedy_nms on the infer CLI's candidates (image1, B=1 K={boxes.shape[1]} "
        f"max_det={md}): {int(valid_k.sum())} kept, {tiles:.2f} tiles; kernel {ms:.4f} ms, per "
        f"call {call_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.5f} ms ({by}) [{card}]")
    kernel = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  tiles_visited=tiles, K=int(boxes.shape[1]), max_det=md)

    # the learning gate's N (phase 13) on the gate's val images
    gate_ckpt = glob.glob(os.path.join(root, "gate", "**", "weights", "last_ckpt.pt"),
                          recursive=True)
    assert len(gate_ckpt) == 1, f"[23] the gate's checkpoint: {gate_ckpt}"
    gate_data = os.path.join(root, "gate", "dataset", "data.json")
    with open(gate_data) as fh:
        val_dir = json.load(fh)["val"]
    out = os.path.join(root, "infer", "gate")
    g = INFER_GATE
    args = infer_cli.get_args_parser().parse_args([
        "--weights", gate_ckpt[0], "--config", os.path.join(ROOT, "configs", "yolov6n.py"),
        "--source", val_dir, "--yaml", gate_data, "--img-size", str(g["img_size"]),
        "--conf-thres", str(g["conf_thres"]), "--save-txt", "--not-save-img", "--save-dir", out,
        "--device", "cuda"])
    with KeepRecorder() as rec:
        infer_cli.run(args)
    n_gt = found = 0
    label_dir = os.path.join(os.path.dirname(os.path.dirname(val_dir)), "labels", "val")
    pred_dir = os.path.join(out, os.path.basename(val_dir), "labels")
    for gt_file in sorted(glob.glob(os.path.join(label_dir, "*.txt"))):
        gt = np.loadtxt(gt_file, ndmin=2).reshape(-1, 5)
        pred_file = os.path.join(pred_dir, os.path.basename(gt_file))
        pred = (np.loadtxt(pred_file, ndmin=2).reshape(-1, 6) if os.path.exists(pred_file)
                else np.zeros((0, 6)))
        for c, x, y, w, h in gt:
            same = pred[pred[:, 0] == c]
            ix = np.clip(np.minimum(x + w / 2, same[:, 1] + same[:, 3] / 2)
                         - np.maximum(x - w / 2, same[:, 1] - same[:, 3] / 2), 0, None)
            iy = np.clip(np.minimum(y + h / 2, same[:, 2] + same[:, 4] / 2)
                         - np.maximum(y - h / 2, same[:, 2] - same[:, 4] / 2), 0, None)
            inter = ix * iy
            ious = inter / (w * h + same[:, 3] * same[:, 4] - inter)
            found += bool((ious >= g["iou"]).any())
            n_gt += 1
    recall = found / max(n_gt, 1)
    log(f"[23] infer CLI with the learning gate's N on its {len(rec.walks)} val images "
        f"({g['img_size']} px, conf {g['conf_thres']}): {found} of {n_gt} GT boxes found by a "
        f"detection of their class at IoU >= {g['iou']} (recall {recall:.4f}, need > "
        f"{g['min_recall']}) [{card}]")
    assert recall > g["min_recall"], f"[23] the gate's N found {found} of {n_gt} GT boxes"
    for r in runs.values():
        r.pop("first", None)
    return dict(launches=sum(r["launches"] for r in runs.values()), gate_launches=len(rec.walks),
                decode_ms=decode_ms, runs=runs, kernel=kernel, gate_recall=recall,
                gate_gt=n_gt, max_abs_err=max(r.get("max_abs_err", 0.0) for r in runs.values()))


# the lite family and the QARepVGG configs (phases 24-28): lite serves,
# trains and evaluates at its 320, whose 40² + 20² + 10² + 5² = 2,125 anchors
# an image are every NMS candidate at the serving defaults
LITE_IMG = 320
LITE_NAMES = ("s", "m", "l")
LITE_SERVE_K = 2125
LITE_TIMED_STEPS = 20  # phase 25's timed train steps
QA_TIMED_STEPS = {"s": 20, "m": 10}  # phase 28's
# phase 27: Lite-S through the train CLI on phase 22's first 64 images
LITE_TRAIN_CLI = dict(batch=32, epochs=2, stop_aug_last_n_epoch=1, workers=8)


def lite_config(name: str):
    from yolov6_tpu_torch.utils.config import Config

    return Config.fromfile(os.path.join(ROOT, "configs", "yolov6_lite", f"yolov6_lite_{name}.py"))


def lite_images(dev, seed: int = 0):
    """b32 random uint8 NHWC images at ``LITE_IMG``, drawn on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (BATCH, LITE_IMG, LITE_IMG, 3), generator=gen, device=dev,
                         dtype=torch.uint8)


def lite_serve_phases(dev, card: str) -> dict:
    """Phase 24: Lite-S, -M and -L deploy graphs serve b32@320 in bf16 at the
    serving defaults (K = 2,125 candidates an image), as phase 18 serves P6:
    the first keep held against the plain emit-once keep, fwd+decode and
    serve timed, the kernel timed on those candidates beside its plain
    version and its bound; then the B=1 serve latency; Lite-S's CPU decode
    of two images held against the CUDA one and one profile of its serve."""
    import torch

    images = lite_images(dev)
    out = {}
    for i, name in enumerate(LITE_NAMES):
        cfg = lite_config(name)
        model = deploy_model(cfg, 30 + i, dev)
        label = f"YOLOv6Lite-{name.upper()}"
        out[name] = timed_serve_phase(cfg, label, model, images, dev, card, "[24]",
                                      cpu_decode=name == "s", profile=name == "s")
        assert out[name]["K"] == LITE_SERVE_K, out[name]["K"]
        b1 = time_serve(model, label, images[:1], dev, card, "[24]")
        out[name].update(b1_fwd_decode_ms=b1["fwd_decode_ms"], b1_serve_ms=b1["serve_ms"],
                         b1_launches=b1["launches"])
        del model
        torch.cuda.empty_cache()
    return out


def lite_train_phase(dev, card: str) -> dict:
    """Phase 25: Lite-S's step at b32@320 on the bench's data (TAL, SIoU, four
    levels), 20 timed, the split and peak memory, 3 ATSS steps; then the
    trained model and its EMA folded and served at conf 0.001."""
    import torch

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms

    cfg = lite_config("s")
    greedy_nms.launches = 0
    step, out = train_phase(cfg, "YOLOv6Lite-S", dev, card, "[25]", LITE_TIMED_STEPS,
                            profile=False, atss_steps=ATSS_STEPS, img=LITE_IMG)
    out["launches"] = greedy_nms.launches
    assert out["launches"] == 0
    out["fold_serve"] = fold_and_serve_phase(cfg, "YOLOv6Lite-S", step, lite_images(dev, 1),
                                             dev, card, "[25]")
    del step
    torch.cuda.empty_cache()
    return out


def lite_cli_phase(root: str, dev, card: str) -> dict:
    """Phase 27: Lite-S through ``tools/train.py`` at 320, batch 32, 2 epochs
    (both on ATSS) over phase 22's 64 train images, with one in-training
    eval of the 160 val images at conf 0, its first keep with a candidate
    held against the plain emit-once keep; then ``tools/infer.py`` at
    ``--img-size 320`` over data/images with Lite-S's seeded serve weights
    (every keep, B=1, equal to the plain keep), and ``hub.yolov6lite_s`` with
    those weights and with its own seeded ones, ``hub.predict(...,
    img_size=320)`` on a demo JPEG, each keep equal to the plain keep."""
    import torch

    from yolov6_tpu_torch import hub
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.tools import infer as infer_cli
    from yolov6_tpu_torch.tools import train as train_cli

    t = LITE_TRAIN_CLI
    conf_file = os.path.join(root, "yolov6_lite_s_train_cli.py")
    with open(os.path.join(ROOT, "configs", "yolov6_lite", "yolov6_lite_s.py")) as f:
        text = f.read()
    with open(conf_file, "w") as f:
        f.write(f"{text}\neval_params = {TRAIN_CLI_EVAL!r}\n")
    argv = ["--data-path", train_subset(root, P6_TRAIN_CLI["n_train"]), "--conf-file", conf_file,
            "--img-size", str(LITE_IMG), "--batch-size", str(t["batch"]),
            "--epochs", str(t["epochs"]), "--workers", str(t["workers"]), "--eval-final-only",
            "--stop_aug_last_n_epoch", str(t["stop_aug_last_n_epoch"]),
            "--output-dir", os.path.join(root, "train"), "--name", "lite_s", "--bf16",
            "--log-interval", "1", "--seed", "0", "--device", "cuda"]
    args = train_cli.get_args_parser().parse_args(argv)
    greedy_nms.launches = 0
    with KeepRecorder() as rec:
        t0 = time.perf_counter()
        trainer = train_cli.main(args)
        wall = time.perf_counter() - t0
    train_launches = greedy_nms.launches
    n_val = EVAL_SET["n_val"]
    walk = rec.check("[27] Lite-S in-training eval", n_val)
    first = walk["first"]["eval"]
    assert walk["launches"] == train_launches == -(-n_val // t["batch"]), walk["launches"]
    assert trainer.atss_warmup_epoch > t["epochs"] - 1 and trainer.model.strides[-1] == 64
    assert (trainer.solver_cfg["lr0"], trainer.solver_cfg["momentum"]) == (0.4, 0.9)
    stats = trainer.epoch_stats
    assert [e["epoch"] for e in stats] == list(range(t["epochs"]))
    assert all(math.isfinite(v) for e in stats for v in e["mean_loss"]), stats
    for e in stats:
        log(f"[27] train CLI Lite-S epoch {e['epoch']} ({'mosaic' if e['epoch'] == 0 else 'letterbox'}"
            f"+affine, ATSS, SIoU): {e['steps']} steps of b{t['batch']}@{LITE_IMG} bf16 in "
            f"{e['wall_s']:.3f} s = {e['imgs_per_s']:.1f} imgs/s with the loader (host clock); "
            f"loader wait {e['loader_wait_s'] / e['steps'] * 1e3:.2f} ms a step; step "
            f"{e['step_ms']:.3f} ms (CUDA events); mean loss [iou, dfl, cls] "
            f"{[round(v, 5) for v in e['mean_loss']]} [{card}]")
    ev = trainer.eval_stats[0]
    log(f"[27] in-training eval of Lite-S's EMA at {LITE_IMG}, conf {TRAIN_CLI_EVAL['conf_thres']}: "
        f"{ev['images']} images in {ev['batches']} batches, {ev['predict_s']:.3f} s = "
        f"{ev['imgs_per_s']:.1f} imgs/s; {walk['launches']} kernel launches, the tile walk in "
        f"every image ({walk['tiles_visited']:.2f} tiles/image), the first batch's keep "
        f"(B={first['boxes'].shape[0]} K={first['boxes'].shape[1]}, {first['kept']} kept) equal "
        f"to the plain emit-once keep; AP50 {ev['ap50']:.5f}; the whole CLI run {wall:.1f} s "
        f"[{card}]")

    model = deploy_model(lite_config("s"), 30, dev)
    weights = os.path.join(root, "infer_lite_s.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, weights)
    del model
    conf_path = os.path.join(ROOT, "configs", "yolov6_lite", "yolov6_lite_s.py")
    out_dir = os.path.join(root, "infer", "lite_s")
    infer_args = infer_cli.get_args_parser().parse_args([
        "--weights", weights, "--config", conf_path, "--source", os.path.join(ROOT, "data",
                                                                             "images"),
        "--img-size", str(LITE_IMG), str(LITE_IMG), "--save-txt", "--save-dir", out_dir,
        "--device", "cuda"])
    greedy_nms.launches = 0
    with KeepRecorder(record_all=True) as irec:
        t0 = time.perf_counter()
        infer_cli.run(infer_args)
        infer_s = time.perf_counter() - t0
    infer_launches = greedy_nms.launches
    keeps, infer_err = irec.check_all("[27] Lite-S infer CLI")
    assert infer_launches == len(keeps) == len(DEMO_JPEGS)
    kept = [int(f["valid"].sum()) for f in keeps]
    ks = [int((f["scores"] > 0).sum()) for f in keeps]
    assert all(f["boxes"].shape[:2] == (1, INFER_CLI["max_nms"]) for f in keeps) and min(kept) > 0
    log(f"[27] infer CLI Lite-S at {LITE_IMG} (conf {INFER_CLI['conf_thres']}, max_det "
        f"{INFER_CLI['max_det']}) over data/images in {infer_s:.2f} s: {infer_launches} kernel "
        f"launches (B=1), K {ks} candidates an image, {kept} kept, each keep equal to the plain "
        f"emit-once keep [{card}]")

    demo = os.path.join(ROOT, sorted(DEMO_JPEGS)[0])
    hub_runs = {}
    for which, w in (("seeded_serve_weights", weights), ("hub_seed", None)):
        model = hub.yolov6lite_s(weights=w, device="cuda")
        greedy_nms.launches = 0
        with KeepRecorder(record_all=True) as hrec:
            dets = hub.predict(model, demo, img_size=LITE_IMG)
        launches = greedy_nms.launches
        hkeeps, herr = hrec.check_all(f"[27] hub {which}")
        assert launches == len(hkeeps) == 1 and hkeeps[0]["boxes"].shape[1] == LITE_SERVE_K
        hub_runs[which] = dict(launches=launches, detections=len(dets), max_abs_err=herr,
                               K=LITE_SERVE_K)
        del model
    assert hub_runs["seeded_serve_weights"]["detections"] > 0
    log(f"[27] hub.yolov6lite_s + hub.predict(img_size={LITE_IMG}) on {os.path.basename(demo)}: "
        f"with the serve's seeded weights {hub_runs['seeded_serve_weights']['detections']} "
        f"detections, with the hub's own seed (the head's prior init) "
        f"{hub_runs['hub_seed']['detections']}; one launch each (B=1, K {LITE_SERVE_K}), equal to "
        f"the plain emit-once keep [{card}]")
    torch.cuda.empty_cache()
    return dict(launches=walk["launches"], epochs=stats, eval=trainer.eval_stats,
                tiles_visited=walk["tiles_visited"], wall_s=wall,
                infer=dict(launches=infer_launches, K=ks, kept=kept, wall_s=infer_s),
                hub=hub_runs,
                max_abs_err=max(walk["max_abs_err"], infer_err,
                                *(h["max_abs_err"] for h in hub_runs.values())))


def qa_phases(images, dev, card: str) -> dict:
    """Phase 28: S-QA's step at b32@640 (20 timed) and M-QA's (10 timed), as
    phase 6 trains S, each then folded (the QARepVGG branches and post-sum
    BN into one conv) and served at conf 0.001 through the kernel."""
    import torch

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.utils.config import Config

    out = {}
    for name, steps in QA_TIMED_STEPS.items():
        cfg = Config.fromfile(os.path.join(ROOT, "configs", "qarepvgg", f"yolov6{name}_qa.py"))
        label = f"YOLOv6{name.upper()}-QA"
        greedy_nms.launches = 0
        step, out[f"train_{name}"] = train_phase(cfg, label, dev, card, "[28]", steps,
                                                 profile=False)
        out[f"train_{name}"]["launches"] = greedy_nms.launches
        assert out[f"train_{name}"]["launches"] == 0
        out[f"{name}_fold_serve"] = fold_and_serve_phase(cfg, label, step, images, dev, card,
                                                         "[28]")
        del step
        torch.cuda.empty_cache()
    return out


# phases 29-31: the PAN necks (configs/experiment/), RepOpt S (configs/repopt/),
# the two-stage RepOpt CLI and upstream .pt files
PAN_NAMES = ("yolov6t", "yolov6s_csp_scaled")
PAN_TRAIN_STEPS = 3  # phase 29's timed yolov6t steps
REPOPT_TIMED_STEPS = 10  # phase 30's timed hs and opt steps
# phase 30's CSLA check on one block, fp32 and TF32 off: the branch step,
# folded, against the masked step of the folded conv, within this share of
# the folded kernel's largest magnitude
CSLA_REL_TOL = 1e-5
# phase 31: the hs and opt stages through the train CLI, 2 epochs each, and the
# fine-tune, 1 epoch, on the first 64 images of phase 12's split; their
# in-training evals and the eval CLI on the first 64 images of phase 11's set
REPOPT_CLI = dict(n_train=64, n_val=64, batch=32, epochs=2, stop_aug_last_n_epoch=1,
                  workers=8)


def config_at(*parts):
    from yolov6_tpu_torch.utils.config import Config

    return Config.fromfile(os.path.join(ROOT, "configs", *parts))


def pan_phases(images, dev, card: str) -> dict:
    """Phase 29: yolov6t and yolov6s_csp_scaled (configs/experiment/: the
    concat PAN necks RepPANNeck and CSPRepPANNeck) serve b32@640 in bf16
    through the kernel as phase 18 serves P6; yolov6t takes 3 timed steps on
    phase 6's cell (SIoU), then is folded and served as in phase 7."""
    import torch

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms

    out = {}
    for i, name in enumerate(PAN_NAMES):
        cfg = config_at("experiment", f"{name}.py")
        model = deploy_model(cfg, 40 + i, dev)
        assert type(model.neck).__name__ == cfg.model.neck.type
        out[f"serve_{name}"] = timed_serve_phase(cfg, name, model, images, dev, card, "[29]")
        del model
        torch.cuda.empty_cache()
    cfg = config_at("experiment", "yolov6t.py")
    greedy_nms.launches = 0
    step, out["train_t"] = train_phase(cfg, "YOLOv6t", dev, card, "[29]", PAN_TRAIN_STEPS,
                                       profile=False)
    out["train_t"]["launches"] = greedy_nms.launches
    assert out["train_t"]["launches"] == 0
    out["t_fold_serve"] = fold_and_serve_phase(cfg, "YOLOv6t", step, images, dev, card, "[29]")
    del step
    torch.cuda.empty_cache()
    return out


def csla_check(hs_model, dev, card: str) -> dict:
    """tests/test_repoptimizer.py::test_csla_sgd_equivalence on the card, at a
    trained hs block's width and scales (fp32, TF32 off): one plain SGD step
    on a LinearAddBlock's linear part (its 3x3, 1x1 and identity branches;
    the scales fixed, the identity's at 1 as the reference's mask assumes),
    folded by ``linearadd_fold``, equals one step of the folded 3x3 conv
    under ``generate_gradient_masks``'s mask."""
    import torch
    from torch import nn

    from yolov6_tpu_torch.layers.common import LinearAddBlock, RealVGGBlock
    from yolov6_tpu_torch.layers.reparam import linearadd_fold
    from yolov6_tpu_torch.solver.repoptimizer import apply_gradient_masks, generate_gradient_masks

    name, src = next((n, m) for n, m in hs_model.named_modules()
                     if isinstance(m, LinearAddBlock) and m.scale_identity is not None)
    c = src.conv.weight.shape[0]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        block = LinearAddBlock(c, c, 3, 1, deploy=False).to(dev)
        block.load_state_dict(src.state_dict())
        with torch.no_grad():
            block.scale_identity.weight.fill_(1.0)
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn((2, c, 40, 40), generator=gen, device=dev)
        tgt = torch.randn((2, c, 40, 40), generator=gen, device=dev)
        lr = 0.1

        def linear(b):
            return b.scale_conv(b.conv(x)) + b.scale_1x1(b.conv_1x1(x)) + b.scale_identity(x)

        ((linear(block) - tgt) ** 2).mean().backward()
        s_conv, s_1x1, s_id = (block.get_submodule(k).weight.detach().cpu().numpy()
                               for k in ("scale_conv", "scale_1x1", "scale_identity"))

        def fold(step):
            w = {k: (block.get_submodule(k).weight
                     - step * block.get_submodule(k).weight.grad).detach().cpu().numpy()
                 for k in ("conv", "conv_1x1", "scale_identity")}
            return linearadd_fold(w["conv"], s_conv, w["conv_1x1"], s_1x1, w["scale_identity"], c)

        after_branches = fold(lr)
        plain = RealVGGBlock(c, c, 3, 1, deploy=False).to(dev)
        with torch.no_grad():
            plain.conv.weight.copy_(torch.from_numpy(fold(0.0)))
        model = nn.Sequential(plain)
        ((nn.functional.conv2d(x, plain.conv.weight, padding=1) - tgt) ** 2).mean().backward()
        apply_gradient_masks(model, generate_gradient_masks(model, {"0": (s_id, s_1x1, s_conv)}))
        after_masked = (plain.conv.weight - lr * plain.conv.weight.grad).detach().cpu().numpy()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    import numpy as np

    err = float(np.abs(after_branches - after_masked).max())
    scale = float(np.abs(after_branches).max())
    moved = float(np.abs(after_branches - fold(0.0)).max())
    log(f"[30] CSLA on the card ({name}, {c} channels, fp32, TF32 off): a plain SGD step on the "
        f"block's branches, folded, vs a masked step on the folded conv: max |diff| {err:.3e} of "
        f"a kernel of max |w| {scale:.3e} (the step moved it by up to {moved:.3e}; tolerance "
        f"{CSLA_REL_TOL} of max |w|) [{card}]")
    assert moved > 10 * err, "the CSLA check's step moved the kernel by less than the error"
    assert err <= CSLA_REL_TOL * scale, f"CSLA: the masked step differs by {err}"
    return dict(block=name, channels=c, max_abs_err=err, max_abs_w=scale, step=moved)


def repopt_phases(images, dev, card: str) -> dict:
    """Phase 30: RepOpt S at full width (configs/repopt/yolov6s_hs.py, then
    yolov6s_opt.py) on phase 6's cell: the hs step (LinearAddBlocks) timed
    with its split and peak memory; the scales from its EMA; the CSLA check
    on one of its blocks; the opt graph re-initialised from the scales, its
    masked step timed; then folded (RealVGG conv+BN) and served through the
    kernel as in phase 7."""
    import torch

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.solver.repoptimizer import extract_scales

    cfgs = {m: config_at("repopt", f"yolov6s_{m}.py") for m in ("hs", "opt")}
    out = {}
    greedy_nms.launches = 0
    step, out["train_hs"] = train_phase(cfgs["hs"], "YOLOv6-S hyper-search (LinearAddBlock)",
                                        dev, card, "[30]", REPOPT_TIMED_STEPS, profile=False)
    scales = extract_scales(step.ema.state_dict())
    spread = [float(abs(s - 1.0).max()) for sc in scales.values() for s in sc]
    log(f"[30] {len(scales)} blocks' CSLA scales from the hs EMA (the scales' largest move "
        f"from their init 1.0: {max(spread):.3e})")
    out["csla"] = csla_check(step.model, dev, card)
    del step
    torch.cuda.empty_cache()
    step, out["train_opt"] = train_phase(cfgs["opt"], "YOLOv6-S RepOpt (RealVGG, masked)", dev,
                                         card, "[30]", REPOPT_TIMED_STEPS, profile=False,
                                         repopt_scales=scales)
    out["launches"] = greedy_nms.launches
    assert out["launches"] == 0
    assert step._mask is not None
    out["opt_fold_serve"] = fold_and_serve_phase(cfgs["opt"], "YOLOv6-S RepOpt", step, images,
                                                 dev, card, "[30]")
    # for phase 32: the trained EMA, the scales and the step's mask buffer
    kept = dict(ema={k: v.detach().to("cpu", copy=True) for k, v in step.ema.state_dict().items()},
                scales=scales, mask=step._mask.detach().to("cpu", copy=True))
    del step
    torch.cuda.empty_cache()
    return out, kept


def val_subset(root: str, n_val: int, train_path: str) -> str:
    """A data description with ``train_path``'s train split and the first
    ``n_val`` images of phase 11's val set (copied once, with their labels);
    returns its path."""
    import glob
    import shutil

    from yolov6_tpu_torch.utils.data_config import load_data_config

    data_path = os.path.join(root, f"data80_train_val{n_val}.json")
    if os.path.exists(data_path):
        return data_path
    data = load_data_config(train_path)
    sub = f"val{n_val}"
    for kind in ("images", "labels"):
        os.makedirs(os.path.join(root, kind, sub))
    for path in sorted(glob.glob(os.path.join(data["val"], "*.png")))[:n_val]:
        stem = os.path.splitext(os.path.basename(path))[0]
        shutil.copy(path, os.path.join(root, "images", sub))
        shutil.copy(os.path.join(root, "labels", "val", f"{stem}.txt"),
                    os.path.join(root, "labels", sub))
    data["val"] = os.path.join(root, "images", sub)
    with open(data_path, "w") as f:
        json.dump(data, f)
    return data_path


def cli_config(root: str, src: str, name: str, **replace) -> str:
    """A copy of the config at ``src`` with ``eval_params`` at conf 0 (as
    phase 12) and each ``key='...'`` line of ``replace`` set; returns its
    path."""
    import re

    with open(src) as f:
        text = f.read()
    for key, value in replace.items():
        text, n = re.subn(rf"{key}\s*=\s*(None|'[^']*')", f"{key}={value!r}", text, count=1)
        assert n == 1, f"no {key}= line in {src}"
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(f"{text}\neval_params = {TRAIN_CLI_EVAL!r}\n")
    return path


def cli_argv(data_path: str, conf: str, root: str, name: str, epochs: int, *extra) -> list:
    """The train CLI's arguments of phases 31 and 32: b32@640 bf16, the
    in-training eval at the last epoch only."""
    t = REPOPT_CLI
    return ["--data-path", data_path, "--conf-file", conf, "--img-size", str(IMG),
            "--batch-size", str(t["batch"]), "--epochs", str(epochs), "--workers",
            str(t["workers"]), "--eval-final-only", "--stop_aug_last_n_epoch",
            str(t["stop_aug_last_n_epoch"]), "--output-dir", os.path.join(root, "train"),
            "--name", name, "--bf16", "--log-interval", "1", "--seed", "0", "--device", "cuda",
            *extra]


def cli_train(data_path: str, conf: str, root: str, name: str, epochs: int, tag: str, card: str,
              label: str, *extra):
    """``tools/train.py::main`` b32@640 in bf16 for ``epochs`` epochs (and
    ``extra`` arguments), its in-training eval's first keep with a candidate
    held against the plain emit-once keep; returns the trainer, the walk and
    the wall time."""
    from yolov6_tpu_torch.tools import train as train_cli

    t = REPOPT_CLI
    argv = cli_argv(data_path, conf, root, name, epochs, *extra)
    args = train_cli.get_args_parser().parse_args(argv)
    with KeepRecorder() as rec:
        t0 = time.perf_counter()
        trainer = train_cli.main(args)
        wall = time.perf_counter() - t0
    walk = rec.check(f"{tag} {label} in-training eval", t["n_val"])
    stats = trainer.epoch_stats
    assert [e["epoch"] for e in stats] == list(range(epochs))
    assert all(math.isfinite(v) for e in stats for v in e["mean_loss"]), stats
    ev = trainer.eval_stats[-1]
    for e in stats:
        log(f"{tag} train CLI {label} epoch {e['epoch']}: {e['steps']} steps of b{t['batch']}@"
            f"{IMG} bf16 in {e['wall_s']:.3f} s = {e['imgs_per_s']:.1f} imgs/s with the loader; "
            f"step {e['step_ms']:.3f} ms (CUDA events); mean loss [iou, dfl, cls] "
            f"{[round(v, 5) for v in e['mean_loss']]} [{card}]")
    log(f"{tag} {label}'s in-training eval: {ev['images']} images, {ev['imgs_per_s']:.1f} imgs/s, "
        f"{walk['launches']} kernel launches, the first keep with a candidate (K "
        f"{walk['first']['eval']['boxes'].shape[1]}, {walk['first']['eval']['kept']} kept) equal "
        f"to the plain emit-once keep; AP50 {ev['ap50']:.5f}; the run {wall:.1f} s [{card}]")
    return trainer, walk, wall


def repopt_cli_phase(root: str, dev, card: str) -> dict:
    """Phase 31, first half: the RepOpt recipe's two stages through the train
    CLI, as the learning gate's ``--repopt`` runs them: configs/repopt/
    yolov6s_hs.py for 2 epochs, then yolov6s_opt.py with ``scales=`` the hs
    run's last_ckpt.pt for 2 epochs, b32@640 bf16 on 64 train images, each
    with its in-training eval of 64 val images through the kernel."""
    t = REPOPT_CLI
    data_path = val_subset(root, t["n_val"], train_subset(root, t["n_train"]))
    hs_conf = cli_config(root, os.path.join(ROOT, "configs", "repopt", "yolov6s_hs.py"),
                         "repopt_hs_cli.py")
    hs, hs_walk, hs_wall = cli_train(data_path, hs_conf, root, "repopt_hs", t["epochs"], "[31]",
                                     card, "S hyper-search")
    scales_ckpt = os.path.join(hs.save_dir, "weights", "last_ckpt.pt")
    opt_conf = cli_config(root, os.path.join(ROOT, "configs", "repopt", "yolov6s_opt.py"),
                          "repopt_opt_cli.py", scales=scales_ckpt)
    opt, opt_walk, opt_wall = cli_train(data_path, opt_conf, root, "repopt_opt", t["epochs"],
                                        "[31]", card, "S RepOpt")
    assert opt.train_step._mask is not None and len(opt.repopt_scales) > 20
    return dict(hs=dict(epochs=hs.epoch_stats, eval=hs.eval_stats, wall_s=hs_wall),
                opt=dict(epochs=opt.epoch_stats, eval=opt.eval_stats, wall_s=opt_wall,
                         blocks=len(opt.repopt_scales)),
                data_path=data_path, scales_ckpt=scales_ckpt,
                opt_ckpt=os.path.join(opt.save_dir, "weights", "last_ckpt.pt"),
                launches=hs_walk["launches"] + opt_walk["launches"],
                max_abs_err=max(hs_walk["max_abs_err"], opt_walk["max_abs_err"]))


def upstream_s_model(dev, seed: int = 44):
    """S's train graph (configs/yolov6s.py, 80 classes) with weights that
    serve as the serve phase's do: the convs He-normal, each RepVGG block's
    1x1 and identity branches zero (the block is then its 3x3 conv and BN,
    like a deploy conv), BNs as built, the head's predictions spread."""
    import torch

    from yolov6_tpu_torch.models.yolo import build_model

    model = build_model(config_at("yolov6s.py"), num_classes=NUM_CLASSES, deploy=False,
                        device=dev)
    init_train_weights(model, torch.Generator(device=dev).manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".rbr_1x1." in name or (".rbr_identity." in name and name.endswith("weight")):
                p.zero_()
            elif "_preds" in name and p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.3
                        / math.sqrt(p[0].numel()))
            elif "_preds" in name:
                low, high = (-4.0, 1.0) if "cls_preds" in name else (1.0, 3.0)
                p.uniform_(low, high, generator=gen)
    return model


def upstream_files_phase(root: str, dev, card: str) -> dict:
    """Phase 31, second half: an upstream-format S ``.pt`` as a release file
    is stripped (whole fp16 modules of a stub ``yolov6`` package,
    ``utils/upstream_ckpt.py::write_upstream_checkpoint``), then, in a child
    process where ``yolov6`` cannot be imported (``upstream_files_child``):
    the eval CLI and the infer CLI read it, and the fine-tune of a copy of
    configs/yolov6s_finetune.py loads it and trains 1 epoch."""
    from yolov6_tpu_torch.utils.upstream_ckpt import write_upstream_checkpoint

    t0 = time.perf_counter()
    model = upstream_s_model(dev)
    path = write_upstream_checkpoint(os.path.join(root, "upstream_yolov6s.pt"), model,
                                     os.path.join(root, "stub_yolov6"))
    del model
    log(f"[31] wrote an upstream-format YOLOv6-S checkpoint through a stub yolov6 package: "
        f"{os.path.getsize(path)} bytes in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--upstream-files", root,
                          path], capture_output=True, text=True, timeout=900, cwd=ROOT)
    wall = time.perf_counter() - t0
    for line in res.stdout.splitlines()[:-1]:
        if line.startswith("[31]"):
            log(line)
    if res.returncode != 0:
        print(res.stdout[-4000:], file=sys.stderr)
        print(res.stderr[-8000:], file=sys.stderr)
        raise RuntimeError(f"[31] the upstream-file child failed (exit {res.returncode})")
    out = json.loads(res.stdout.splitlines()[-1])
    out["child_wall_s"] = wall
    log(f"[31] the child process (eval CLI, infer CLI, fine-tune) took {wall:.1f} s")
    return out


def upstream_files_child(argv) -> int:
    """The child of phase 31 (``chip_smoke.py --upstream-files <root>
    <checkpoint>``); prints its results as its last line."""
    import importlib.util

    assert importlib.util.find_spec("yolov6") is None, "the yolov6 package is importable"
    import torch

    from yolov6_tpu_torch.core.engine import Trainer
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.tools import eval as eval_cli
    from yolov6_tpu_torch.tools import infer as infer_cli
    from yolov6_tpu_torch.tools import train as train_cli
    from yolov6_tpu_torch.utils.checkpoint import read_state_dict
    from yolov6_tpu_torch.utils.upstream_ckpt import checkpoint_format

    root, path = argv
    card = nvidia_smi_line()
    t = REPOPT_CLI
    assert checkpoint_format(path) == "upstream"
    s_conf = os.path.join(ROOT, "configs", "yolov6s.py")
    data_path = val_subset(root, t["n_val"], train_subset(root, t["n_train"]))
    out = {}

    greedy_nms.launches = 0
    with KeepRecorder() as rec:
        t0 = time.perf_counter()
        (ap50, ap), rows = eval_cli.run(data=data_path, weights=path, config=s_conf,
                                        batch_size=t["batch"], img_size=IMG, task="val",
                                        half=True, save_dir=os.path.join(root, "eval_upstream"),
                                        device="cuda")
        wall = time.perf_counter() - t0
    walk = rec.check("[31] eval CLI on the upstream file", t["n_val"])
    assert greedy_nms.launches == walk["launches"] == -(-t["n_val"] // t["batch"])
    assert 0.0 <= ap50 <= 1.0 and 0.0 <= ap <= 1.0 and len(rows) > 0
    out["eval"] = dict(launches=walk["launches"], ap50=ap50, ap=ap, rows=len(rows), wall_s=wall,
                       max_abs_err=walk["max_abs_err"])
    log(f"[31] eval CLI (tools/eval.py::run) on the upstream .pt with configs/yolov6s.py: "
        f"{t['n_val']} images, {len(rows)} COCO rows, AP50 {ap50:.5f}, AP {ap:.5f}, "
        f"{walk['launches']} kernel launches, the first keep equal to the plain keep, "
        f"{wall:.1f} s [{card}]")

    infer_args = infer_cli.get_args_parser().parse_args([
        "--weights", path, "--config", s_conf, "--source", os.path.join(ROOT, "data", "images"),
        "--save-txt", "--save-dir", os.path.join(root, "infer_upstream"), "--device", "cuda"])
    greedy_nms.launches = 0
    with KeepRecorder(record_all=True) as irec:
        t0 = time.perf_counter()
        infer_cli.run(infer_args)
        wall = time.perf_counter() - t0
    keeps, err = irec.check_all("[31] infer CLI on the upstream file")
    assert greedy_nms.launches == len(keeps) == len(DEMO_JPEGS)
    kept = [int(f["valid"].sum()) for f in keeps]
    assert min(kept) > 0
    out["infer"] = dict(launches=len(keeps), kept=kept, wall_s=wall, max_abs_err=err)
    log(f"[31] infer CLI (tools/infer.py::run) on the upstream .pt over data/images: "
        f"{len(keeps)} kernel launches (B=1), {kept} kept, each keep equal to the plain keep, "
        f"{wall:.1f} s [{card}]")

    conf = cli_config(root, os.path.join(ROOT, "configs", "yolov6s_finetune.py"),
                      "yolov6s_finetune_upstream.py", pretrained=path)
    args = train_cli.get_args_parser().parse_args([
        "--data-path", data_path, "--conf-file", conf, "--img-size", str(IMG), "--batch-size",
        str(t["batch"]), "--epochs", "1", "--workers", str(t["workers"]), "--output-dir",
        os.path.join(root, "train"), "--name", "finetune_upstream", "--bf16", "--log-interval",
        "1", "--seed", "0", "--device", "cuda"])
    cfg = train_cli.check_and_init(args)
    t0 = time.perf_counter()
    trainer = Trainer(args, cfg)
    want = read_state_dict(path)
    got = trainer.model.state_dict()
    n = len(got)
    assert trainer.pretrained_matched == (n, n), trainer.pretrained_matched
    assert all(torch.equal(got[k].cpu(), v) for k, v in want.items())
    greedy_nms.launches = 0
    with KeepRecorder() as rec:
        trainer.train()
    wall = time.perf_counter() - t0
    walk = rec.check("[31] fine-tune's in-training eval", t["n_val"])
    e = trainer.epoch_stats[0]
    assert all(math.isfinite(v) for v in e["mean_loss"])
    out["finetune"] = dict(matched=n, launches=walk["launches"], epoch=e, wall_s=wall,
                           ap50=trainer.eval_stats[-1]["ap50"], max_abs_err=walk["max_abs_err"])
    log(f"[31] fine-tune of a copy of configs/yolov6s_finetune.py from the upstream .pt: "
        f"{n} of {n} tensors loaded, each equal to the file's; 1 epoch of {e['steps']} steps, "
        f"mean loss {[round(v, 5) for v in e['mean_loss']]}, the in-training eval's first keep "
        f"equal to the plain keep ({walk['launches']} launches); {wall:.1f} s [{card}]")
    assert importlib.util.find_spec("yolov6") is None and "yolov6" not in sys.modules
    out["launches"] = out["eval"]["launches"] + out["infer"]["launches"] + walk["launches"]
    out["max_abs_err"] = max(out[k]["max_abs_err"] for k in ("eval", "infer", "finetune"))
    print(json.dumps(out), flush=True)
    return 0


# phase 32: INT8 quantisation, RepOpt's third stage, on configs/repopt/
# yolov6s_opt_qat.py at full width: PTQ of [30]'s trained S (4 calibration
# batches b32@640 of phase 6's cell), the quantised serve, the QAT step, the
# calibration and QAT stages through the train CLI on [31]'s subset, and the
# PTQ CLI on [13]'s gate checkpoint, whose mAP50 may fall at most
# ``map50_drop`` below the float eval of the same file (a bar set before the
# first run on the card)
QUANT = dict(calib_batches=4, cpu_images=2, amax_rel=1e-5, timed_steps=20, gate_img=160,
             gate_batch=16, gate_calib_batches=8, map50_drop=0.05)


def ptq_serve_phase(kept, images, dev, card: str) -> dict:
    """Phase 32a: [30]'s trained RepOpt S EMA folded into the deploy graph of
    yolov6s_opt_qat.py; its conv input ranges calibrated in fp32 on 2 images
    on the card and on the CPU (TF32 off; relative ``amax_rel``), then on
    ``calib_batches`` b32@640 batches of phase 6's cell (the first its
    images, the others from the next seeds); the weights fake-quantised per
    channel; the folded model served b32@640 in bf16 at FOLD_SERVE in float,
    then quantised (``quant_mode``): the quantised serve's first keep equal
    to the plain emit-once keep, both timed (10 calls after 3), the
    fake-quant's share of the call and one profile. Returns the numbers and
    the ranges."""
    import numpy as np
    import torch

    from yolov6_tpu_torch.layers.reparam import fold_to_deploy
    from yolov6_tpu_torch.models.end2end import make_end2end_fn
    from yolov6_tpu_torch.models.yolo import build_model
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.quant.ptq import calibrate, quantize_variables
    from yolov6_tpu_torch.quant.state import quant_mode, quant_paths

    q = QUANT
    cfg = config_at("repopt", "yolov6s_opt_qat.py")
    model = build_model(cfg, num_classes=NUM_CLASSES, deploy=True, device=dev)
    model.load_state_dict(fold_to_deploy(kept["ema"], model), strict=True)
    batches = [torch.from_numpy(np.random.default_rng(i).integers(
        0, 255, (BATCH, IMG, IMG, 3), np.uint8)).to(dev) for i in range(q["calib_batches"])]

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        two = batches[0][:q["cpu_images"]]
        on_card = calibrate(model, [two])
        cpu_model = build_model(cfg, num_classes=NUM_CLASSES, deploy=True, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        on_cpu = calibrate(cpu_model, [two.cpu()])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert set(on_card) == set(on_cpu) == set(quant_paths(model).values())
    assert all(v.device.type == "cuda" for v in on_card.values())
    amax_err = max(abs(float(on_card[k]) - float(v)) / float(v) for k, v in on_cpu.items())
    log(f"[32] PTQ calibration of {len(on_cpu)} conv inputs of the folded RepOpt S on "
        f"{q['cpu_images']} images in fp32 (TF32 off): the card's ranges vs the CPU's, largest "
        f"relative difference {amax_err:.3e} (tolerance {q['amax_rel']})")
    assert amax_err <= q["amax_rel"], f"[32] the card's ranges differ from the CPU's: {amax_err}"
    del cpu_model

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amax = calibrate(model, batches)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    assert all(float(v) > 0 for v in amax.values())
    torch.backends.cudnn.allow_tf32 = True
    serve16 = make_end2end_fn(model, **FOLD_SERVE, with_preprocess=True, half=True, device=dev)
    with torch.inference_mode():
        float_fd = cuda_ms(lambda: forward_decode(images, model, half=True), iters=10, warmup=3)
    float_ms = cuda_ms(lambda: serve16(images), iters=10, warmup=3)
    model.load_state_dict(quantize_variables(model.state_dict(), model), strict=True)
    with quant_mode(model, amax):
        greedy_nms.launches = 0
        with KeepRecorder("serve") as rec:
            num_dets, boxes, scores, _ = serve16(images)
            torch.cuda.synchronize()
        launches = greedy_nms.launches
        walk = rec.check("[32] PTQ serve", BATCH, labels=("serve",))
        assert launches > 0, "[32] the quantised serve did not launch the NMS kernel"
        assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
        total = int(num_dets.sum())
        assert total > 0, "[32] the quantised serve found no detections"
        with torch.inference_mode():
            q_fd = cuda_ms(lambda: forward_decode(images, model, half=True), iters=10, warmup=3)
        q_ms = cuda_ms(lambda: serve16(images), iters=10, warmup=3)
        prof = profile_calls(lambda: serve16(images), card, tag="[32]",
                             what="PTQ bf16 serve calls")
    first = walk["first"]["serve"]
    share = (q_ms - float_ms) / q_ms
    log(f"[32] calibrated {len(amax)} ranges on {q['calib_batches']} b{BATCH}@{IMG} batches in "
        f"{calib_s:.2f} s (fp32, TF32 on); weights fake-quantised per channel (8 bits)")
    log(f"[32] PTQ serve of the folded RepOpt S b{BATCH}@{IMG} bf16 at {FOLD_SERVE}: fwd+decode "
        f"{q_fd:.3f} ms, serve {q_ms:.3f} ms = {BATCH / q_ms * 1e3:.1f} imgs/s; the same model in "
        f"float: fwd+decode {float_fd:.3f} ms, serve {float_ms:.3f} ms = "
        f"{BATCH / float_ms * 1e3:.1f} imgs/s; the fake quantisation {share:.3f} of the "
        f"quantised call; {total} detections, {launches} NMS kernel launch(es), the keep (B="
        f"{first['boxes'].shape[0]} K={first['boxes'].shape[1]}, {first['kept']} kept, "
        f"{walk['tiles_visited']:.2f} tiles/image) equal to the plain emit-once keep [{card}]")
    out = dict(ranges=len(amax), amax_cpu_rel_err=amax_err, calib_s=calib_s, fwd_decode_ms=q_fd,
               serve_ms=q_ms, imgs_per_s=BATCH / q_ms * 1e3, float_fwd_decode_ms=float_fd,
               float_serve_ms=float_ms, float_imgs_per_s=BATCH / float_ms * 1e3,
               fake_quant_share=share, launches=launches, tiles_visited=walk["tiles_visited"],
               max_abs_err=walk["max_abs_err"], K=int(first["boxes"].shape[1]), profile=prof)
    del model, serve16
    torch.cuda.empty_cache()
    return out, amax


def qat_step_phase(kept, amax, dev, card: str) -> dict:
    """Phase 32b: the QAT step of yolov6s_opt_qat.py (RealVGG, masked by
    [30]'s scales, fake-quantised with 32a's ranges) from [30]'s EMA, b32@640
    bf16 on phase 6's cell, timed as phase 6 with its split and peak memory:
    every loss finite, the ranges bit-unchanged after the steps, and the
    step's gradient masks equal to [30]'s."""
    import torch

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms

    frozen = {k: v.clone() for k, v in amax.items()}
    cfg = config_at("repopt", "yolov6s_opt_qat.py")
    greedy_nms.launches = 0
    step, out = train_phase(cfg, "YOLOv6-S QAT (RealVGG, masked, fake-quantised)", dev, card,
                            "[32]", QUANT["timed_steps"], profile=False,
                            repopt_scales=kept["scales"], init_state=kept["ema"],
                            quant=dict(amax=amax, num_bits=8, skip_patterns=[]))
    out["launches"] = greedy_nms.launches
    assert out["launches"] == 0
    assert set(step.quant["amax"]) == set(frozen)
    changed = [k for k, v in step.quant["amax"].items() if not torch.equal(v, frozen[k])]
    assert not changed, f"[32] QAT moved the ranges of {changed}"
    assert step._mask is not None and torch.equal(step._mask.cpu(), kept["mask"]), \
        "[32] the QAT step's gradient masks differ from [30]'s"
    log(f"[32] after {int(step.step)} QAT steps the {len(frozen)} ranges are bit-unchanged and the "
        f"step's gradient masks equal [30]'s ({int((kept['mask'] != 1).sum())} masked entries)")
    del step
    torch.cuda.empty_cache()
    return out


def qat_cli_phase(root: str, repopt_cli: dict, dev, card: str) -> dict:
    """Phase 32c: RepOpt's third stage through ``tools/train.py::main`` on
    [31]'s 64 train and 64 val images: a copy of yolov6s_opt_qat.py with
    ``pretrained`` [31]'s RepOpt last_ckpt.pt, ``scales`` its hs one and
    ``calib_output_path`` under this phase's directory; ``--quant --calib``,
    then ``--quant`` for 1 epoch from the calibration file, its in-training
    eval quantised (fake-quant calls counted) through the kernel, its first
    keep with a candidate held against the plain keep; the QAT checkpoint's
    ranges equal to the calibration's."""
    import torch

    from yolov6_tpu_torch.core.engine import Trainer
    from yolov6_tpu_torch.quant import state as quant_state
    from yolov6_tpu_torch.tools import train as train_cli
    from yolov6_tpu_torch.utils.checkpoint import read_state_dict

    data_path = repopt_cli["data_path"]
    qdir = os.path.join(root, "qat_calib")
    src = os.path.join(ROOT, "configs", "repopt", "yolov6s_opt_qat.py")
    paths = dict(pretrained=repopt_cli["opt_ckpt"], scales=repopt_cli["scales_ckpt"],
                 calib_output_path=qdir)
    calib_conf = cli_config(root, src, "qat_calib_cli.py", **paths)
    args = train_cli.get_args_parser().parse_args(
        cli_argv(data_path, calib_conf, root, "qat_calib", 1, "--quant", "--calib"))
    t0 = time.perf_counter()
    calib = train_cli.main(args)
    calib_wall = time.perf_counter() - t0
    assert calib.calib_path == os.path.join(qdir, "calib_ckpt.pt") and not calib.epoch_stats
    _, calib_amax = read_state_dict(calib.calib_path, with_quant=True)
    assert calib_amax and all(float(v) > 0 for v in calib_amax.values())
    log(f"[32] train CLI --quant --calib (S opt-qat, pretrained [31]'s RepOpt run): "
        f"{len(calib_amax)} ranges over the train loader's batches written to "
        f"{os.path.basename(calib.calib_path)} in {calib_wall:.1f} s [{card}]")

    qat_conf = cli_config(root, src, "qat_cli.py", calib_pt=calib.calib_path, **paths)
    calls = {"train": 0, "eval": 0}
    now = ["train"]
    real_fake_quant, real_eval = quant_state.fake_quant, Trainer.eval_model

    def counting(*a, **kw):
        calls[now[0]] += 1
        return real_fake_quant(*a, **kw)

    def eval_model(self):
        now[0] = "eval"
        try:
            real_eval(self)
        finally:
            now[0] = "train"

    quant_state.fake_quant, Trainer.eval_model = counting, eval_model
    try:
        qat, walk, wall = cli_train(data_path, qat_conf, root, "qat", 1, "[32]", card, "S QAT",
                                    "--quant")
    finally:
        quant_state.fake_quant, Trainer.eval_model = real_fake_quant, real_eval
    assert qat.warmup_stepnum == 0 and qat.train_step._mask is not None
    n_steps = qat.epoch_stats[0]["steps"]
    assert calls["train"] == n_steps * len(calib_amax), calls
    assert calls["eval"] > 0 and calls["eval"] % len(calib_amax) == 0, calls
    _, qat_amax = read_state_dict(os.path.join(qat.save_dir, "weights", "last_ckpt.pt"),
                                  with_quant=True)
    assert set(qat_amax) == set(calib_amax)
    assert all(torch.equal(qat_amax[k], v) for k, v in calib_amax.items()), \
        "[32] the QAT checkpoint's ranges differ from the calibration's"
    log(f"[32] QAT's {n_steps} steps and in-training eval ran {calls['train']} and "
        f"{calls['eval']} fake quantisations; the QAT checkpoint's {len(qat_amax)} ranges equal "
        f"the calibration's [{card}]")
    return dict(calib_wall_s=calib_wall, ranges=len(calib_amax), epochs=qat.epoch_stats,
                eval=qat.eval_stats, wall_s=wall, fake_quant_calls=calls,
                launches=walk["launches"], max_abs_err=walk["max_abs_err"])


def ptq_cli_phase(root: str, dev, card: str) -> dict:
    """Phase 32d: ``tools/quantize.py --eval`` on [13]'s gate checkpoint
    (configs/yolov6n.py, ``gate_calib_batches`` batches of the gate's train
    images, the gate's 64 val images at 160 px, bf16) beside the eval CLI's
    float eval of the same file: each eval's first keep with a candidate
    held against the plain keep, and the PTQ mAP50 at most ``map50_drop``
    below the float one."""
    import glob

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.tools import eval as eval_cli
    from yolov6_tpu_torch.tools import quantize as quantize_cli

    q = QUANT
    gate_ckpt = glob.glob(os.path.join(root, "gate", "**", "weights", "last_ckpt.pt"),
                          recursive=True)
    assert len(gate_ckpt) == 1, f"[32] the gate's checkpoint: {gate_ckpt}"
    gate_data = os.path.join(root, "gate", "dataset", "data.json")
    conf = os.path.join(ROOT, "configs", "yolov6n.py")
    size = ["--img-size", str(q["gate_img"]), "--batch-size", str(q["gate_batch"])]
    greedy_nms.launches = 0
    with KeepRecorder() as rec:
        t0 = time.perf_counter()
        (f50, f5095), _ = eval_cli.run(gate_data, gate_ckpt[0], conf, q["gate_batch"],
                                       q["gate_img"], save_dir=os.path.join(root, "ptq_float"),
                                       device="cuda")
        float_wall = time.perf_counter() - t0
    float_launches = greedy_nms.launches
    with open(gate_data) as f:
        n_val = len(glob.glob(os.path.join(json.load(f)["val"], "*.png")))
    fwalk = rec.check("[32] eval CLI on the gate's N (float)", n_val)
    greedy_nms.launches = 0
    args = quantize_cli.get_args_parser().parse_args([
        "--weights", gate_ckpt[0], "--config", conf, "--data", gate_data, *size,
        "--calib-batches", str(q["gate_calib_batches"]), "--output",
        os.path.join(root, "ptq", "gate_n_ptq8.pt"), "--eval", "--device", "cuda"])
    with KeepRecorder() as rec:
        t0 = time.perf_counter()
        path, amax, (q50, q5095) = quantize_cli.main(args)
        ptq_wall = time.perf_counter() - t0
    ptq_launches = greedy_nms.launches
    qwalk = rec.check("[32] quantize CLI --eval on the gate's N", n_val)
    log(f"[32] the gate's N at {q['gate_img']} px, bf16: float (eval CLI) mAP50 {f50:.4f}, "
        f"mAP50-95 {f5095:.4f} in {float_wall:.1f} s; PTQ (tools/quantize.py --eval, "
        f"{q['gate_calib_batches']} calibration batches of {q['gate_batch']}, {len(amax)} ranges) "
        f"mAP50 {q50:.4f}, mAP50-95 {q5095:.4f} in {ptq_wall:.1f} s (bar: PTQ mAP50 >= float - "
        f"{q['map50_drop']}); {float_launches} and {ptq_launches} kernel launches, each first "
        f"keep with a candidate equal to the plain emit-once keep [{card}]")
    assert q50 >= f50 - q["map50_drop"], f"[32] PTQ mAP50 {q50} below float {f50} - bar"
    return dict(float_map50=f50, float_map50_95=f5095, ptq_map50=q50, ptq_map50_95=q5095,
                float_wall_s=float_wall, ptq_wall_s=ptq_wall, ranges=len(amax),
                float_launches=float_launches, launches=ptq_launches,
                max_abs_err=max(fwalk["max_abs_err"], qwalk["max_abs_err"]))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "yolov6_tpu_torch")):
        print(f"chip_smoke: the yolov6_tpu_torch package is not beside this script in {ROOT}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2

    import numpy as np

    from yolov6_tpu_torch.ops.cuda import build
    from yolov6_tpu_torch.ops.cuda.nms_kernel import TILE, greedy_nms, greedy_nms_plain
    from yolov6_tpu_torch.utils.config import Config

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = nvidia_smi_line()

    # ---- 1. card, versions, build
    phase_mark("[1]")
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.build()
    log(f"[1] built every kernel in {time.perf_counter() - t0:.2f} s")
    for name, (secs, out) in build.BUILD_LOG.items():
        log(f"[1] nvcc {name}.cu: {secs:.2f} s; " + " | ".join(
            ln.strip() for ln in out.splitlines() if "Used" in ln or "spill" in ln))

    # ---- 2. kernel vs plain at the keep shapes of the serving and eval paths
    keep_rows = {}
    for i, (name, B, K, md, iou) in enumerate(KEEP_SHAPES):
        unsorted = clustered_candidates(10 + i, B, K, dev)
        inputs = {"sorted": sort_candidates(*unsorted), "unsorted": unsorted}
        for order, (boxes, scores) in inputs.items():
            for emit_once in (True, False):
                idx_k, valid_k = greedy_nms(boxes, scores, md, iou, emit_once=emit_once)
                idx_p, valid_p = greedy_nms_plain(boxes, scores, md, iou, emit_once=emit_once)
                torch.cuda.synchronize()
                what = f"{name}, {order}, emit_once={emit_once}"
                assert torch.equal(valid_k, valid_p), f"{what}: valid differs from the plain keep"
                assert torch.equal(idx_k, idx_p), f"{what}: idx differs from the plain keep"
                assert (greedy_nms.last_path == int(order == "sorted")).all(), \
                    f"{what}: wrong path {greedy_nms.last_path.tolist()}"
                n_valid = int(valid_k.sum())
                assert n_valid > B * md // 2, f"{what}: only {n_valid} kept, the chain is too short"
        # times on the sorted candidates under the default rule, the main path's
        boxes, scores = inputs["sorted"]
        idx_k, valid_k = greedy_nms(boxes, scores, md, iou)
        torch.cuda.synchronize()
        tiles = float(greedy_nms.last_tiles.float().mean())
        ms = cuda_ms(lambda: greedy_nms(boxes, scores, md, iou), iters=20, queue_ahead=True)
        # one row: the scores pass, then the first tile with a single resolve step
        one_row_ms = cuda_ms(lambda: greedy_nms(boxes, scores, 1, iou), iters=20, queue_ahead=True)
        call_ms = cuda_ms(lambda: greedy_nms(boxes, scores, md, iou), iters=20)
        argmax_ms = cuda_ms(lambda: greedy_nms(*unsorted, md, iou), iters=20, queue_ahead=True)
        plain_ms = cuda_ms(lambda: greedy_nms_plain(boxes, scores, md, iou), iters=3, warmup=1)
        b_ms, b_by = bound_ms(*keep_work_sorted(boxes, scores, idx_k, valid_k, TILE))
        any_ms, any_by = bound_ms(*keep_work(boxes, scores, idx_k, valid_k, iou))
        keep_rows[name] = dict(ms=ms, one_row_ms=one_row_ms, call_ms=call_ms,
                               argmax_ms=argmax_ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by, any_order_bound_ms=any_ms,
                               any_order_bound_by=any_by, tiles_visited=tiles)
        log(f"[2] greedy_nms {name} B={B} K={K} max_det={md} iou={iou}: equal to plain on "
            f"sorted and unsorted candidates under both rules, {int(valid_k.sum())} kept; "
            f"sorted (tile walk, {tiles:.2f} tiles/image): kernel {ms:.4f} ms (with max_det 1 "
            f"{one_row_ms:.4f} ms), per call {call_ms:.4f} ms; unsorted (argmax loop) {argmax_ms:.4f} ms; plain "
            f"{plain_ms:.3f} ms; bound {b_ms:.5f} ms ({b_by}; in any order {any_ms:.5f} ms, "
            f"{any_by}) [{card}]")

    images_np = np.random.default_rng(0).integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    images = torch.from_numpy(images_np).to(dev)
    cfgs = {name: Config.fromfile(os.path.join(ROOT, "configs", f"yolov6{name}.py"))
            for name in ("s", "m", "l")}

    # ---- 3.-5. YOLOv6-S: the serving path at full width, fp32 checks, bf16 times, profile
    phase_mark("[3]")
    model = deploy_model(cfgs["s"], 0, dev)
    main = serve_phase(cfgs["s"], "YOLOv6-S", model, images_np, images, dev, card, "[3]")
    log(f"[4] greedy_nms at the serving shape {keep_rows['serving']['ms']:.4f} ms, at the "
        f"eval-protocol shape {keep_rows['eval_protocol']['ms']:.4f} ms [{card}]")
    time_serve(model, "YOLOv6-S", images, dev, card, "[4]", profile_tag="[5]")

    # ---- 6. the S training step at full width, bf16 (no kernel of this repo on its path)
    phase_mark("[6]")
    greedy_nms.launches = 0
    step, _ = train_phase(cfgs["s"], "YOLOv6-S", dev, card, "[6]", TRAIN["timed_steps"])
    train_launches = greedy_nms.launches

    # ---- 7. fold the trained S into the deploy graph and serve it
    fold = fold_and_serve_phase(cfgs["s"], "YOLOv6-S", step, images, dev, card, "[7]")
    del step, model

    # ---- 8. YOLOv6-M served at full width: fp32 checks, the kernel on M's candidates, bf16
    phase_mark("[8]")
    model = deploy_model(cfgs["m"], 1, dev)
    m_serve = serve_phase(cfgs["m"], "YOLOv6-M", model, images_np, images, dev, card, "[8]",
                          decode_tol=DECODE_TOL_M)
    time_serve(model, "YOLOv6-M", images, dev, card, "[8]", profile_tag="[8]")
    del model

    # ---- 9. M's training step (TAL with DFL, then ATSS), the fold and the folded serve
    greedy_nms.launches = 0
    step, _ = train_phase(cfgs["m"], "YOLOv6-M", dev, card, "[9]", TRAIN["timed_steps"],
                       atss_steps=ATSS_STEPS)
    train_m_launches = greedy_nms.launches
    fold_m = fold_and_serve_phase(cfgs["m"], "YOLOv6-M", step, images, dev, card, "[9]")
    del step

    # ---- 10. YOLOv6-L: bf16 serve through the kernel, then 3 + 5 train steps
    phase_mark("[10]")
    model = deploy_model(cfgs["l"], 2, dev)
    serve_l_launches = time_serve(model, "YOLOv6-L", images, dev, card, "[10]")["launches"]
    del model
    greedy_nms.launches = 0
    step, _ = train_phase(cfgs["l"], "YOLOv6-L", dev, card, "[10]", L_TIMED_STEPS,
                          profile=False)
    train_l_launches = greedy_nms.launches
    del step

    # ---- 11.-13. COCO evaluation of S and M (and S on rect batches) on a PNG
    # set, the train CLI on a train split beside it, the learning gate
    phase_mark("[11]")
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as root:
        data = write_eval_set(root, card)
        perfect_mock_phase(data, dev, card)
        model = deploy_model(cfgs["s"], 0, dev)
        eval_s = eval_phase(model, "YOLOv6-S", data, dev, card)
        eval_s_rect = eval_phase(model, "YOLOv6-S", data, dev, card, rect=True)
        del model
        model = deploy_model(cfgs["m"], 1, dev)
        eval_m = eval_phase(model, "YOLOv6-M", data, dev, card)
        del model

        train_data = write_train_split(root, card)
        aug_ms = augmentation_ms(train_data, card)
        greedy_nms.launches = 0
        train_cli = train_cli_phase(train_data, root, dev, card)
        train_cli_launches = greedy_nms.launches
        greedy_nms.launches = 0
        gate = learning_gate_phase(root, card)
        gate_launches = greedy_nms.launches

        # ---- 14.-16. the training recipes' steps; 17. the distill gate
        phase_mark("[14]")
        recipes = recipe_phases(cfgs, images, dev, card)
        greedy_nms.launches = 0
        distill_gate = distill_gate_phase(root, card)
        distill_gate_launches = greedy_nms.launches

        # ---- 18.-20. the P6 family at 1280: serve, train and fold, evaluate
        phase_mark("[18]")
        p6_cfgs = {name: Config.fromfile(os.path.join(ROOT, "configs", f"yolov6{name}.py"))
                   for name in P6_NAMES}
        p6_serve = p6_serve_phases(p6_cfgs, dev, card)
        p6_train = p6_train_phases(p6_cfgs, dev, card)
        model = deploy_model(p6_cfgs["l6"], 13, dev)
        eval_l6 = eval_phase(model, "YOLOv6-L6", data, dev, card, img=P6_IMG,
                             shrink=L6_EVAL_SHRINK, tag="[20]")
        del model
        torch.cuda.empty_cache()

        # ---- 21. the MBLA stage; 22. N6 through the train CLI at 1280
        phase_mark("[21]")
        mbla = mbla_phases(dev, card, images)
        greedy_nms.launches = 0
        p6_cli = p6_train_cli_phase(root, dev, card)
        p6_cli_launches = greedy_nms.launches

        # ---- 23. inference: the demo JPEGs, the infer CLI on S, the gate's N
        phase_mark("[23]")
        greedy_nms.launches = 0
        infer = infer_phase(root, dev, card)
        infer_launches = greedy_nms.launches

        # ---- 24.-27. the lite family at 320: serve, the Lite-S step and fold,
        # Lite-S through the Evaler, the train, infer and hub entries
        phase_mark("[24]")
        lite_serve = lite_serve_phases(dev, card)
        lite_train = lite_train_phase(dev, card)
        model = deploy_model(lite_config("s"), 30, dev)
        eval_lite_s = eval_phase(model, "YOLOv6Lite-S", data, dev, card, img=LITE_IMG,
                                 tag="[26]")
        del model
        lite_cli = lite_cli_phase(root, dev, card)

        # ---- 28. the QARepVGG configs: S-QA and M-QA steps, folds, folded serves
        phase_mark("[28]")
        qa_train = qa_phases(images, dev, card)

        # ---- 29. the PAN necks; 30. RepOpt S; 31. RepOpt's two stages through the
        # train CLI, and an upstream .pt through the eval, infer and train CLIs
        phase_mark("[29]")
        pan = pan_phases(images, dev, card)
        phase_mark("[30]")
        repopt, repopt_kept = repopt_phases(images, dev, card)
        phase_mark("[31]")
        greedy_nms.launches = 0
        repopt_cli = repopt_cli_phase(root, dev, card)
        repopt_cli_launches = greedy_nms.launches
        upstream = upstream_files_phase(root, dev, card)

        # ---- 32. INT8 quantisation: PTQ and the quantised serve of [30]'s S, the QAT
        # step, RepOpt's third stage through the train CLI, the PTQ CLI on [13]'s N
        phase_mark("[32]")
        ptq_serve, amax = ptq_serve_phase(repopt_kept, images, dev, card)
        qat_step = qat_step_phase(repopt_kept, amax, dev, card)
        del repopt_kept, amax
        greedy_nms.launches = 0
        qat_cli = qat_cli_phase(root, repopt_cli, dev, card)
        qat_cli_launches = greedy_nms.launches
        ptq_cli = ptq_cli_phase(root, dev, card)
        phase_mark("end")
    assert train_cli_launches >= train_cli["launches"] and gate_launches == gate["launches"]
    assert distill_gate_launches == distill_gate["launches"]
    assert all(recipes[k]["launches"] == 0 for k in ("train_fuse_ab", "train_distill_ns",
                                                     "train_m_kd"))
    assert p6_train["train_s6"]["launches"] == p6_train["train_l6"]["launches"] == 0
    assert mbla["train_s"]["launches"] == 0 and p6_cli_launches == p6_cli["launches"]
    assert infer_launches == infer["launches"] + infer["gate_launches"]
    assert repopt_cli_launches == repopt_cli["launches"]
    assert pan["train_t"]["launches"] == repopt["launches"] == qat_step["launches"] == 0
    assert qat_cli_launches == qat_cli["launches"]
    log("phase wall times (s): " + ", ".join(
        f"{a} {tb - ta:.1f}" for (a, ta), (_, tb) in zip(PHASE_MARKS, PHASE_MARKS[1:])))

    kernels = [{
        "name": "greedy_nms",
        "route": "cuda",
        "source": "yolov6_tpu_torch/ops/cuda/csrc/nms_kernel.cu",
        "replaces": "yolov6_tpu/ops/pallas/nms_kernel.py:27",
        "launches": main["launches"],
        "launches_by_path": {"serve": main["launches"], "train": train_launches,
                             "serve_folded_trained": fold["launches"],
                             "serve_m": m_serve["launches"], "train_m": train_m_launches,
                             "serve_m_folded_trained": fold_m["launches"],
                             "serve_l": serve_l_launches, "train_l": train_l_launches,
                             "eval_s": eval_s["launches"], "eval_m": eval_m["launches"],
                             "eval_s_rect": eval_s_rect["launches"],
                             "train_cli_eval": train_cli_launches,
                             "learning_gate_eval": gate_launches,
                             "train_fuse_ab": recipes["train_fuse_ab"]["launches"],
                             "fuse_ab_fold_serve": recipes["fuse_ab_fold_serve"]["launches"],
                             "train_distill_ns": recipes["train_distill_ns"]["launches"],
                             "distill_ns_fold_serve":
                                 recipes["distill_ns_fold_serve"]["launches"],
                             "train_m_kd": recipes["train_m_kd"]["launches"],
                             "distill_gate_teacher_eval": distill_gate["teacher_launches"],
                             "distill_gate_eval": distill_gate["student_launches"],
                             **{f"serve_{name}": p6_serve[name]["launches"]
                                for name in P6_NAMES},
                             "train_s6": p6_train["train_s6"]["launches"],
                             "s6_fold_serve": p6_train["s6_fold_serve"]["launches"],
                             "train_l6": p6_train["train_l6"]["launches"],
                             "l6_fold_serve": p6_train["l6_fold_serve"]["launches"],
                             "eval_l6": eval_l6["launches"],
                             "serve_x_mbla": mbla["serve_x"]["launches"],
                             "train_s_mbla": mbla["train_s"]["launches"],
                             "s_mbla_fold_serve": mbla["s_fold_serve"]["launches"],
                             "train_cli_n6_eval": p6_cli_launches,
                             "infer": infer["launches"], "infer_gate": infer["gate_launches"],
                             **{f"serve_lite_{name}": lite_serve[name]["launches"]
                                for name in LITE_NAMES},
                             **{f"serve_lite_{name}_b1": lite_serve[name]["b1_launches"]
                                for name in LITE_NAMES},
                             "train_lite_s": lite_train["launches"],
                             "lite_s_fold_serve": lite_train["fold_serve"]["launches"],
                             "eval_lite_s": eval_lite_s["launches"],
                             "train_cli_lite_s_eval": lite_cli["launches"],
                             "infer_lite_s": lite_cli["infer"]["launches"],
                             **{f"hub_lite_s_{k}": v["launches"]
                                for k, v in lite_cli["hub"].items()},
                             **{f"train_{name}_qa": qa_train[f"train_{name}"]["launches"]
                                for name in QA_TIMED_STEPS},
                             **{f"{name}_qa_fold_serve": qa_train[f"{name}_fold_serve"]["launches"]
                                for name in QA_TIMED_STEPS},
                             **{f"serve_{name}": pan[f"serve_{name}"]["launches"]
                                for name in PAN_NAMES},
                             "train_yolov6t": pan["train_t"]["launches"],
                             "yolov6t_fold_serve": pan["t_fold_serve"]["launches"],
                             "train_s_hs_and_repopt": repopt["launches"],
                             "s_repopt_fold_serve": repopt["opt_fold_serve"]["launches"],
                             "repopt_cli_evals": repopt_cli["launches"],
                             "upstream_eval_cli": upstream["eval"]["launches"],
                             "upstream_infer_cli": upstream["infer"]["launches"],
                             "upstream_finetune_eval": upstream["finetune"]["launches"],
                             "serve_s_ptq": ptq_serve["launches"],
                             "train_s_qat": qat_step["launches"],
                             "qat_cli_eval": qat_cli_launches,
                             "eval_cli_gate_n_float": ptq_cli["float_launches"],
                             "quantize_cli_eval_gate_n": ptq_cli["launches"]},
        "matches_plain": True,
        "max_abs_err": max(main["max_abs_err"], m_serve["max_abs_err"],
                           *(e["kernel"]["max_abs_err"] for e in (eval_s, eval_m, eval_s_rect)),
                           train_cli["max_abs_err"], gate["max_abs_err"],
                           fold["max_abs_err"], fold_m["max_abs_err"],
                           recipes["fuse_ab_fold_serve"]["max_abs_err"],
                           recipes["distill_ns_fold_serve"]["max_abs_err"],
                           distill_gate["max_abs_err"],
                           *(p6_serve[name]["max_abs_err"] for name in P6_NAMES),
                           p6_train["s6_fold_serve"]["max_abs_err"],
                           p6_train["l6_fold_serve"]["max_abs_err"],
                           eval_l6["kernel"]["max_abs_err"], mbla["serve_x"]["max_abs_err"],
                           mbla["s_fold_serve"]["max_abs_err"], p6_cli["max_abs_err"],
                           infer["max_abs_err"],
                           *(lite_serve[name]["max_abs_err"] for name in LITE_NAMES),
                           lite_train["fold_serve"]["max_abs_err"],
                           eval_lite_s["kernel"]["max_abs_err"], lite_cli["max_abs_err"],
                           *(qa_train[f"{name}_fold_serve"]["max_abs_err"]
                             for name in QA_TIMED_STEPS),
                           *(pan[f"serve_{name}"]["max_abs_err"] for name in PAN_NAMES),
                           pan["t_fold_serve"]["max_abs_err"],
                           repopt["opt_fold_serve"]["max_abs_err"], repopt_cli["max_abs_err"],
                           upstream["max_abs_err"], ptq_serve["max_abs_err"],
                           qat_cli["max_abs_err"], ptq_cli["max_abs_err"]),
        "path": main["path"],
        "tiles_visited": main["tiles_visited"],
        "ms": main["ms"],
        "call_ms": main["call_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "any_order_bound_ms": main["any_order_bound_ms"],
        "library_ms": None,
        "shape": f"B={BATCH} K={main['K']} max_det={main['max_det']}",
        "shapes": {name: dict(B=B, K=K, max_det=m, **keep_rows[name])
                   for name, B, K, m, _ in KEEP_SHAPES},
        "on_m_candidates": {k: m_serve[k] for k in (
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "any_order_bound_ms",
            "tiles_visited", "K", "max_det")},
        "on_eval_candidates": {"s": eval_s["kernel"], "m": eval_m["kernel"],
                               "s_rect": eval_s_rect["kernel"]},
        "eval": {name: {k: v for k, v in e.items() if k != "kernel"}
                 for name, e in (("s", eval_s), ("m", eval_m), ("s_rect", eval_s_rect))},
        "train_cli": dict(train_cli, augmentation_ms=aug_ms),
        "learning_gate": gate,
        "tiles_by_path": {
            "serve_folded_trained": fold["tiles_visited"],
            "serve_m_folded_trained": fold_m["tiles_visited"],
            "fuse_ab_fold_serve": recipes["fuse_ab_fold_serve"]["tiles_visited"],
            "distill_ns_fold_serve": recipes["distill_ns_fold_serve"]["tiles_visited"],
            "distill_gate_evals": distill_gate["tiles_visited"]},
        "recipes": {k: v for k, v in recipes.items() if k.startswith("train_")},
        "distill_gate": distill_gate,
        "on_p6_serve_candidates": p6_serve,
        "p6_train": p6_train,
        "eval_l6": eval_l6,
        "mbla": mbla,
        "p6_train_cli": p6_cli,
        "on_infer_candidates": infer["kernel"],
        "infer": {k: v for k, v in infer.items() if k != "kernel"},
        "on_lite_serve_candidates": lite_serve,
        "lite_train": lite_train,
        "eval_lite_s": eval_lite_s,
        "lite_cli": lite_cli,
        "qa_train": qa_train,
        "pan": pan,
        "repopt": repopt,
        "repopt_cli": repopt_cli,
        "upstream": upstream,
        "quant": dict(ptq_serve=ptq_serve, qat_step=qat_step, qat_cli=qat_cli, ptq_cli=ptq_cli),
    }]
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--upstream-files"]:
        sys.exit(upstream_files_child(sys.argv[2:]))
    sys.exit(main())
