#!/usr/bin/env python3
"""Drive the PyTorch port (yolov6_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root, one CUDA device

Phases, each of which asserts:
  1. the card, the versions, and the build of every CUDA kernel from csrc/;
  2. each kernel against its plain torch version on the card, at the NMS
     shapes of the serving and eval paths (equal outputs required): the keep
     on sorted candidates (the op as the selection calls it) and on
     unsorted ones (the wrapper's stable sort first), under both rules; timed on the sorted ones, the main path's;
  3. the serving path at full width: YOLOv6-S (configs/yolov6s.py, 80
     classes, deploy) serving 32 uint8 images of 640x640 in fp32 through
     ``make_end2end_fn``; the NMS kernel must be launched, take the tile walk
     in every image (at the serving setting and at the eval protocol) and find
     detections; the default keep must equal the plain emit-once keep and
     ``'pallas'`` the plain loop on the same predictions, ``'perclass'``
     (the JAX package's per-class keep) must launch the kernel and equal the
     default keep, and the CPU decode of two of the images must agree with
     the CUDA decode (M in phase 8 the same);
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
     takes 3 + 5 steps in bf16 with DFL; then ``utils/model_info.py`` on
     the S, M and L deploy graphs at 640, built on ``meta``, logged beside
     BASELINE.md's parameters and FLOPs;
 11. COCO evaluation: the port's generator writes a synthetic val set of 64
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
     time and idle share from a profiled second pass; one more, untimed S
     eval with ``do_pr_metric``, ``plot_curve`` and
     ``plot_confusion_matrix`` must launch the keep once a batch and write
     the five PNGs (read back at 2250x1500), logging the host seconds of
     ``ap_per_class`` and of the rendering;
 12. the train CLI: a 96-image PNG train split beside phase 11's val set
     (the same sizes, another seed); ``tools/train.py::main`` trains
     YOLOv6-S (80 classes, the config's data_aug: mosaic 1.0, mixup 0.0)
     b32@640 in bf16 for 2 epochs, epoch 0 on the mosaic branch and epoch 1
     on the letterbox+affine branch, with one in-training eval of the 64
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
     epoch 0, and the in-training eval's imgs/s. The run writes TensorBoard
     with ``--write_trainbatch_tb``: its event file, read back by
     ``read_events`` (both CRCs), must hold per epoch the 8 scalars, the LRs
     equal to ``group_lrs_host``, a 1920x1920 ``train_batch`` at the epoch's
     first step, and after the eval one ``val_img_*`` an image with a
     prediction (up to 8); the plot's and the event writes' host seconds are
     logged. Then ``data/vis_dataset.py`` draws the labels of 4 of the split's
     images;
 13. the learning gate (``tools/learning_gate.py`` at its defaults: YOLOv6-N,
     160 px, 256 train and 64 val images, 4 classes, 30 epochs, batch 16,
     seed 0, the exact-NMS pass on): final mAP50 > 0.75 and a gain > 0.20,
     the tile walk in every image of its evals, and the first batch with a
     candidate of its in-training eval, of its checkpoint evals and of its
     exact-NMS pass each kept as the plain emit-once keep keeps it; it logs
     the trajectory, the exact-NMS delta and the wall time. It runs in a
     child process started when group 11 starts, beside phases 11-31, and
     is joined before phase 23, which reads its checkpoint;
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
     defaults but ``--teacher-epochs 10``, in a child process started with
     phase 13's when group 11 starts and joined at the end, so that the two
     gates share the card and the host with each other and with the main
     process's phases, whose lines say so: the fuse-AB N teacher 10 epochs,
     then the distill-NS N student 30, 160 px, fp32): the student's final
     mAP50 > 0.75 and a gain > 0.20, the tile
     walk in every image of its evals, and the first keep with a candidate of
     the teacher's in-training eval, the student's, its checkpoint evals and
     its exact-NMS pass each held against the plain emit-once keep, and its
     launches counted as its recorder counts them; it logs the teacher's
     final mAP50, the trajectory and the wall time;
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
     0.03, IoU 0.65, multi-label, max_det 300) over phase 11's 64 PNG
     images, with phase 11's checks and numbers;
 21. the MBLA stage (configs/mbla/): X-MBLA's deploy graph serves b32@640
     as in phase 18; S-MBLA's training step at b32@640 (DFL, TAL) as phase 6
     (20 timed steps), then folded and served as in phase 7;
 22. N6 through the train CLI at 1280, batch 8, 2 epochs (both on the ATSS
     branch) over the first 32 images of phase 12's split, with one
     in-training eval of the 64 val images at conf 0: its first keep with a
     candidate held against the plain emit-once keep; imgs/s an epoch,
     loader wait and step time a step;
 23. inference: the repository's demo JPEGs (data/images) decode to the
     sha256 of cv2.imread's pixels (host decode timed); the infer CLI
     (``tools/infer.py::run``, in-process) runs full-width S with seeded
     weights over data/images at its defaults (conf 0.4, IoU 0.45, max_det
     1000, max_nms 2000: K = 2000 candidates an image), in fp32 and with
     ``--half``, then with ``--classes 0 2`` and ``--agnostic-nms``: one
     kernel launch an image, each keep equal to the plain emit-once keep, a
     JPEG at the source's size and a label row a detection; a second run in
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
 26. Lite-S through the Evaler at 320 over phase 11's 64 PNG images at the
     eval protocol, with phase 11's checks and numbers;
 27. Lite-S through the train CLI at 320, batch 32, 2 epochs (both on ATSS)
     over phase 22's 32 train images, with one in-training eval at conf 0 (its
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
     CLI's float eval of the same file: PTQ mAP50 at most 0.05 below float;
 33. export and serving: S (phase 3's weights) exported end2end as ``.pt2``
     b32@640 in bf16 and fp32, each loaded by ``load_serving`` in a fresh
     ``python3 -c`` that imports only yolov6_tpu_torch and served phase 4's
     images: the kernel launched from inside the artifact, its keep equal to
     the plain keep on the artifact's own candidates, the detections as the
     live serve's (fp32 TF32 off: boxes within 1e-4 of the box scale; bf16
     within the decode tolerances), both calls timed; ``Evaler.init_artifact``
     on an eval-protocol ``.pt2`` over 64 of [11]'s images: COCO rows and AP
     equal to the live Evaler's; S's ONNX file through ``OnnxTorchModule`` at
     b32 (5e-4 / 1e-4 of the live forward plus decode) and once through the
     numpy runner at B=1, and [32]'s PTQ S as a QDQ file against its
     fake-quantised forward (every element within 5e-4 / 1e-4); S traced to TorchScript and run; Lite-S's NCNN
     files run by the numpy executor against the card's head maps;
 34. data parallel on the one card (``parallel/dist.py``, ``layers/sync_bn.py``),
     each rank a child process: [34a] two gloo ranks take [6]'s cell (S's
     train form, b32@640 global, 16 a rank, the bench's data and solver) in
     fp32 with TF32 off for 3 steps, held to one process at b32 with the JAX
     SPMD contract's tolerances (step-0 loss rtol 1e-4; parameters and BN
     running statistics after step 0 rtol 2e-3, atol 1e-6; trajectory rtol
     2e-3), both ranks bit-equal and no keep launched; [34b]
     ``tools/train.py::main`` in two gloo ranks, global b32, 2 epochs over
     64 train images with ``--cache disk`` and an eval of 64 val images at the
     end: each rank launches the keep on its device (its first keep with a
     candidate equal to the plain keep), rank 0's gathered rows equal a
     one-process Evaler's on the run's EMA row for row, both ranks hold the
     same APs, and rank 1 writes nothing under the run's directory, where
     rank 0 writes one TensorBoard event file; [34c]
     [6]'s bf16 step in an NCCL group of one equals the step without a group
     bit for bit (as a second plain step does), beside [34a] and [34b];
 35. the image files cv2 reads and writes, and the CLIs that rest on them:
     [35a] the committed fixtures of tests/data/torch_images/ (progressive
     and truncated JPEG; 16-bit, palette, grey+alpha, sub-byte and Adam7 PNG;
     1-32-bit BMP) decode to the SHA-256 of cv2.imread's pixels, and the demo
     JPEGs' pixels encode to cv2.imencode's bytes, by the host libraries the
     card machine's g++ builds; [35b] N through ``tools/train.py::main`` at
     ``--specific-shape --height 384 --width 640 --check-images
     --check-labels``, b16, 1 epoch over [31]'s 64 images plus four fixtures,
     a file of garbage (dropped) and an out-of-range label file (its labels
     dropped), the truncated JPEG restored in place, its in-training eval of
     64 images square at 640 through the kernel; [35c]
     ``tools/repro_gate.py::main`` on 16 of [11]'s images as a COCO-layout
     JPEG set with an upstream-format N ``.pt``: the published protocol (K
     8192) and the exact one (K 30,000), every keep equal to the plain keep,
     exit code 1 and S ``SKIP (no weights)``; [35d] the infer CLI with that
     file writes image1-3.jpg as JPEGs at the sources' sizes;
 36. TIFF, WebP and the other formats the JAX package reads: [36a] the
     TIFF, DNG, WebP, MPO, RLE BMP, CMYK/YCCK JPEG and PNG ``eXIf`` fixtures
     decode to the SHA-256 of the JAX package's pixels and its refusals
     raise, the demo JPEGs encode to cv2.imencode('.tif')'s bytes and to
     lossless WebP read back exactly, and each decoder is timed on a
     640x640 file; [36b] S through ``tools/eval.py::run`` at b32@640 bf16
     over [11]'s 64 images rewritten as 32 TIFF and 32 WebP gives the PNG
     set's COCO rows row for row, 2 keep launches, the first with a
     candidate equal to the plain keep; [36c] the infer CLI with [35c]'s N
     file over a TIFF and a lossy WebP source (and their PNG twins) writes
     cv2's TIFF bytes and a lossless WebP of the drawn pixels, every keep
     equal to the plain keep;
 37. video: [37a] the MPEG-4 Part 2 and Motion JPEG files of
     tests/data/torch_videos/ (MP4, MOV, AVI, MKV) decode to their
     manifest's frames (sha256), count, fps and size, the port's writer
     makes a 1280x720 clip of [11]'s 64 images at 30 fps, and its encode and
     decode (and a Motion JPEG frame's) are timed a frame; [37b] the infer
     CLI with [13]'s gate N over that clip: one keep launch a frame, 64 in
     all, the first with a candidate and every eighth equal to the plain
     keep, the written .mp4 read back at 64 frames, 30 fps, 1280x720, the
     label rows, the loop's imgs/s and its steps a frame; [37c] the ONNX
     demo's video loop with [33c]'s file over the clip's first 16 frames,
     its printed frame and detection counts;
 38. drawing (host): the times of the g++ builds of the TrueType text and
     the anti-aliased shapes, made at their first use before [13] and [17]
     start; the text, boxes, labels, shapes and FPS
     overlay of tests/data/torch_draw/hashes.json and the synthetic
     generator's first 4 images equal to the SHA-256 of the JAX package's
     cv2 5.0 drawing; ``plot_box_and_label`` over a 1080x810 image of 1000
     detections and ``put_text`` of a label timed;
 39. the train path's JPEG read (host, and a train CLI epoch): [39a] the
     files of tests/data/torch_jpeg_train/ through ``load_image_rgb`` at 64
     and at 96x160 give their manifest's SHA-256 (the JAX native library's
     DCT-scaled decode and bilinear; cv2's for the Exif-6 file), and
     through ``imread`` cv2.imread's (block-smoothed where cut short);
     [39b] the read of a 1920x1080 and a 4032x3024 JPEG at 640 (DCT scale
     1/2 and 1/4) timed beside ``imread`` and ``resize_linear``; [39c] one
     mosaic epoch of S b32@640 bf16 through the train CLI over [11]'s 64
     images written as 1920x1080 JPEGs, its imgs/s and loader wait a step
     beside [12]'s PNG epoch, its in-training eval's 2 keep launches.
Phases run in the order of their numbers but for [23], which runs after
[31], once [13]'s gate (a child process from the start of group [11]) is
joined.
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

import contextlib
import json
from functools import partial
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
# phase 22: N6 through the train CLI on the first 32 images of phase 12's split
# (first 64)
P6_TRAIN_CLI = dict(n_train=32, batch=8, epochs=2, stop_aug_last_n_epoch=1, workers=8)

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


# the gate phases that run in child processes beside the main process's
# phases: (tag, process) while started and not yet joined
CHILDREN = []
# the children's tags that ran at some time during the current phase group
SHARED_WITH = set()


def log(msg: str) -> None:
    """Print a phase line. While a gate child runs (or ran during this phase
    group), a line of another phase says so: whatever it timed shared the
    card and the host with that child."""
    SHARED_WITH.update(tag for tag, proc in CHILDREN if proc.poll() is None)
    tag = msg.split(" ", 1)[0]
    others = sorted(t for t in SHARED_WITH if not tag.startswith(t))
    if msg.startswith("[") and others:
        msg += f" {{beside the child{'ren' if len(others) > 1 else ''} of " \
               f"{' and '.join(others)}, sharing the card and the host}}"
    print(msg, flush=True)


PHASE_MARKS = []  # (phase tag, host clock) at the start of each phase group


def phase_mark(tag: str) -> None:
    PHASE_MARKS.append((tag, time.perf_counter()))
    SHARED_WITH.clear()
    if len(PHASE_MARKS) > 1:
        log(f"phase group {tag} starts {PHASE_MARKS[-1][1] - PHASE_MARKS[0][1]:.1f} s after [1]")


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
    default rule). Bytes: every score, which the count of the prefix reads,
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
              + 4 * B)
    return nbytes, int(17 * (ahead + pairs))


def keep_work(boxes, scores, idx, valid, iou_thres):
    """(bytes, operations) the greedy keep needs for these inputs in any
    order (an argmax loop's count): each input read once and each output
    written once; per step run, one compare per candidate for the argmax and
    17 operations of IoU and test per candidate still alive. A step runs for
    each valid row, plus one that finds nothing alive when the loop ends
    early."""
    import torch

    B, K = scores.shape
    md = idx.shape[1]
    # idx, valid, and the kernel's tiles per image
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + idx.numel() * 4 + valid.numel() + 4 * B
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
    from yolov6_tpu_torch.ops.cuda.nms_kernel import (
        TILE, greedy_nms, greedy_nms_op, greedy_nms_plain,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n_params = sum(p.numel() for p in model.parameters())
    serve = make_end2end_fn(model, **SERVE, with_preprocess=True, half=False, device=dev)

    greedy_nms.launches = 0
    num_dets, boxes, scores, classes = serve(images)
    torch.cuda.synchronize()
    launches = greedy_nms.launches
    assert launches > 0, f"{label}: serving did not launch the NMS kernel"
    tiles = float(greedy_nms.last_tiles.float().mean())
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

        # 'perclass' (the JAX package's per-class keep) on the same predictions
        # at the serving setting: through the kernel, the default's output
        t0 = time.perf_counter()
        greedy_nms.launches = 0
        pc_dets, pc_valid = nms_mod.non_max_suppression(preds, **SERVE, method="perclass")
        torch.cuda.synchronize()
        perclass_launches = greedy_nms.launches
        dets_d, valid_d = nms_mod.non_max_suppression(preds, **SERVE)
        assert perclass_launches > 0, f"{label}: 'perclass' did not launch the kernel"
        assert torch.equal(pc_valid, valid_d) and torch.equal(pc_dets, dets_d), \
            f"{label}: 'perclass' differs from the default keep"
        log(f"{tag} non_max_suppression(method='perclass') on {label}'s served predictions: "
            f"{perclass_launches} kernel launch(es), {int(pc_valid.sum())} detections equal to "
            f"the default keep's; {time.perf_counter() - t0:.2f} s")

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
            max_abs_err = max(max_abs_err, float((idx_k - idx_p).abs().max()))
        ms = cuda_ms(lambda: greedy_nms_op(nms_boxes, cand_scores, md, iou, True), iters=20,
                     queue_ahead=True)
        call_ms = cuda_ms(lambda: greedy_nms_op(nms_boxes, cand_scores, md, iou, True), iters=20)
        plain_ms = cuda_ms(lambda: greedy_nms_plain(nms_boxes, cand_scores, md, iou),
                           iters=3, warmup=1)
        bound, by = bound_ms(*keep_work_sorted(nms_boxes, cand_scores, idx_k, valid_k, TILE))
        any_bound, any_by = bound_ms(*keep_work(nms_boxes, cand_scores, idx_k, valid_k, iou))
        log(f"{tag} greedy_nms on {label}'s served candidates B={BATCH} K={nms_boxes.shape[1]} "
            f"max_det={md}, both rules equal to plain: kernel {ms:.4f} ms, per call "
            f"{call_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.5f} ms "
            f"({by}; in any order {any_bound:.5f} ms, {any_by}) [{card}]")
    return dict(launches=launches, tiles_visited=tiles, max_abs_err=max_abs_err,
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                any_order_bound_ms=any_bound, K=nms_boxes.shape[1], max_det=md,
                perclass_launches=perclass_launches)


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


# the eval phase's set: 64 PNG images in four sizes (w, h), so that the
# loader both shrinks (INTER_AREA, 768x576) and enlarges (INTER_LINEAR, 320x240)
# (first 320, then 160: each cut kept the script under its time limit on a
# slower host as phase groups were added; two b32 batches still exercise the
# pipeline and the rect buckets)
EVAL_SET = dict(n_val=64, seed=0, sizes=[(640, 480), (480, 640), (768, 576), (320, 240)])


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
            self.walks.append((tiles, boxes.shape[1]))
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

        walked = torch.cat([t for t, _ in self.walks])
        assert len(walked) >= n_images, f"{what}: {len(walked)} images walked, {n_images} evaluated"
        tiles = float(walked.float().mean())
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
                    K=sorted({k for _, k in self.walks}), max_abs_err=err,
                    first={label: self.first[label] for label in labels})


    def check_all(self, what: str):
        """Every recorded launch equals the plain keep under its rule; returns
        the launches and the largest index error."""
        import torch

        from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms_plain

        assert self.record_all and len(self.all) == len(self.walks) > 0, what
        err = 0.0
        for i, f in enumerate(self.all):
            idx_p, valid_p = greedy_nms_plain(f["boxes"], f["scores"], f["max_det"],
                                              f["iou_thres"], emit_once=f["emit_once"])
            assert torch.equal(f["idx"], idx_p) and torch.equal(f["valid"], valid_p), \
                f"{what}: launch {i}'s keep differs from the plain keep"
            err = max(err, float((f["idx"] - idx_p).abs().max()))
        return self.all, err


def keep_spy(limit: int = 0):
    """A ``TorchDispatchMode`` that records, while active, the inputs and
    outputs of the ``yolov6::greedy_nms`` calls (the first ``limit`` of them,
    0 for all) in its ``calls`` list as ``(boxes, scores, max_det,
    iou_thres, emit_once, idx, valid)``: it sees the keep also where a
    loaded ``.pt2`` calls the op from inside its graph. Every op, the keep
    included, runs as it would without it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class KeepSpy(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.yolov6.greedy_nms.default and not (
                    limit and len(self.calls) >= limit):
                self.calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                                        for a in (*args, *out)))
            return out

    return KeepSpy()


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
    from yolov6_tpu_torch.ops.cuda.nms_kernel import (
        TILE, greedy_nms, greedy_nms_op, greedy_nms_plain,
    )

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
    ms = cuda_ms(lambda: greedy_nms_op(nms_boxes, scores, md, iou, True), iters=20, queue_ahead=True)
    call_ms = cuda_ms(lambda: greedy_nms_op(nms_boxes, scores, md, iou, True), iters=20)
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


PLOT_FILES = ("PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png",
              "confusion_matrix.png")


def eval_plots_phase(model, data: dict, root: str, dev, card: str) -> dict:
    """[11]: one more, untimed S eval over the val set with ``do_pr_metric``,
    ``plot_curve`` and ``plot_confusion_matrix``: the keep launched once a
    batch (its first keep with a candidate equal to the plain keep) and the
    five PNGs written, each read back at 2250x1500; logs the host seconds of
    ``ap_per_class`` and of the rendering."""
    from yolov6_tpu_torch.core.evaler import Evaler
    from yolov6_tpu_torch.data.image_io import imread
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.utils import metrics

    out_dir = os.path.join(root, "eval_plots")
    os.makedirs(out_dir)
    render = {"curves": 0.0}
    real = {name: getattr(metrics, name) for name in ("plot_pr_curve", "plot_mc_curve")}

    def timed(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                render["curves"] += time.perf_counter() - t0
        return wrapper

    t_start = time.perf_counter()
    evaler = Evaler(dict(data), batch_size=BATCH, img_size=IMG, half=True, save_dir=out_dir,
                    do_pr_metric=True, plot_curve=True, plot_confusion_matrix=True, device=dev)
    evaler.init_model(model)
    loader = evaler.init_data(None, "val")
    for name, fn in real.items():
        setattr(metrics, name, timed(fn))
    try:
        with KeepRecorder() as rec:
            greedy_nms.launches = 0
            evaler.predict_model(model, loader)
            launches = greedy_nms.launches
    finally:
        for name, fn in real.items():
            setattr(metrics, name, fn)
    walk = rec.check("[11] eval with plots", EVAL_SET["n_val"])
    assert launches == len(evaler.batch_split) == walk["launches"], launches
    assert evaler.pr_results is not None and all(math.isfinite(v) for v in evaler.pr_results)
    assert sorted(f for f in os.listdir(out_dir) if f.endswith(".png")) == sorted(PLOT_FILES)
    for name in PLOT_FILES:
        shape = imread(os.path.join(out_dir, name)).shape
        assert shape == (1500, 2250, 3), f"[11] {name}: {shape}"
    wall = time.perf_counter() - t_start
    ap_s = evaler.plot_s["ap_per_class"]
    cm_s = evaler.plot_s["confusion_matrix"]
    log(f"[11] eval S with do_pr_metric, plot_curve and plot_confusion_matrix over "
        f"{EVAL_SET['n_val']} images: {launches} kernel launches (the first keep with a "
        f"candidate equal to the plain keep); the five PNGs at 2250x1500; host seconds: "
        f"ap_per_class {ap_s:.3f} (of which rendering the four curves {render['curves']:.3f}), "
        f"the confusion matrix's rendering {cm_s:.3f}; PR mAP50 {evaler.pr_results[0]:.5f}; "
        f"{wall:.1f} s in all [{card}]")
    return dict(launches=launches, max_abs_err=walk["max_abs_err"], wall_s=wall,
                ap_per_class_s=ap_s, curves_render_s=render["curves"], confusion_render_s=cm_s,
                pr_results=list(evaler.pr_results))


# BASELINE.md's params (M) and FLOPs (G) at 640 (upstream README.md:41-44)
MODEL_INFO_BASELINE = {"s": (18.5, 45.3), "m": (34.9, 85.8), "l": (59.6, 150.7)}


def model_info_phase(card: str) -> dict:
    """``utils/model_info.py`` on the S, M and L deploy graphs at 640, built on
    ``meta``: parameters and FLOPs beside BASELINE.md's."""
    import torch

    from yolov6_tpu_torch.models.yolo import build_model
    from yolov6_tpu_torch.utils.config import Config
    from yolov6_tpu_torch.utils.model_info import count_flops, count_params, get_model_info

    t0 = time.perf_counter()
    out = {}
    for name, (params_m, gflops) in MODEL_INFO_BASELINE.items():
        cfg = Config.fromfile(os.path.join(ROOT, "configs", f"yolov6{name}.py"))
        with torch.device("meta"):
            model = build_model(cfg, NUM_CLASSES, deploy=True, device="meta")
        n, flops = count_params(model), count_flops(model, (IMG, IMG))
        info = get_model_info(model, (IMG, IMG))
        assert info.startswith(f"Params: {n / 1e6:.2f}M, GFLOPs: "), info
        out[name] = dict(params_m=n / 1e6, gflops=flops / 1e9, baseline_params_m=params_m,
                         baseline_gflops=gflops)
        log(f"[10] model_info YOLOv6-{name.upper()} deploy @{IMG}: {info} (BASELINE.md "
            f"{params_m}M / {gflops}G; FLOPs {100 * (flops / 1e9 / gflops - 1):+.2f}%)")
    log(f"[10] model_info of S, M and L on meta: {time.perf_counter() - t0:.2f} s [{card}]")
    return out


def vis_dataset_phase(data_path: str, root: str, card: str) -> dict:
    """[12]: ``data/vis_dataset.py`` on the first 4 images of the train split:
    4 PNGs at their sources' sizes, each with labels drawn."""
    from yolov6_tpu_torch.data.image_io import imread
    from yolov6_tpu_torch.data.vis_dataset import visualize
    from yolov6_tpu_torch.utils.data_config import load_data_config

    data = load_data_config(data_path)
    img_dir = data["train"]
    label_dir = img_dir.replace(os.path.join("images", "train"), os.path.join("labels", "train"))
    t0 = time.perf_counter()
    written = visualize(img_dir, label_dir, os.path.join(root, "vis"),
                        class_names=data["names"], max_images=4)
    secs = time.perf_counter() - t0
    assert len(written) == 4, written
    for path in written:
        src = imread(os.path.join(img_dir, os.path.basename(path)))
        drawn = imread(path)
        assert drawn.shape == src.shape and (drawn != src).any(), path
    log(f"[12] vis_dataset on 4 train images: 4 PNGs with their labels drawn in {secs:.2f} s "
        f"[{card}]")
    return dict(images=len(written), wall_s=secs)


TB_SCALARS = ("val/mAP@0.5", "val/mAP@0.50:0.95", "train/iou_loss", "train/dist_focalloss",
              "train/cls_loss", "x/lr0", "x/lr1", "x/lr2")


def tensorboard_check(trainer, path: str, epochs: int, card: str) -> dict:
    """[12]'s event file, read back by ``read_events``: per epoch the eight
    scalars at ``epoch + 1`` with the LRs of ``group_lrs_host``, a
    1920x1920 ``train_batch`` at each epoch's first step, and after the
    final eval one ``val_img_*`` an image with a prediction (up to 8)."""
    import numpy as np

    from yolov6_tpu_torch.solver.build import group_lrs_host
    from yolov6_tpu_torch.utils.tb_writer import read_events

    t0 = time.perf_counter()
    events = read_events(path)
    read_s = time.perf_counter() - t0
    scalars, images = {}, {}
    for e in events:
        for tag, v in e.get("scalars", {}).items():
            scalars.setdefault(tag, {})[e["step"]] = v
        for tag, v in e.get("images", {}).items():
            images.setdefault(tag, {})[e["step"]] = v
    steps = trainer.max_stepnum
    assert sorted(scalars) == sorted(TB_SCALARS), sorted(scalars)
    for tag in TB_SCALARS:
        assert sorted(scalars[tag]) == list(range(1, epochs + 1)), (tag, sorted(scalars[tag]))
    for epoch in range(epochs):
        lrs = group_lrs_host((epoch + 1) * steps, float(epoch), trainer.warmup_stepnum,
                             trainer.solver_cfg, trainer.max_epoch)
        for k, lr in enumerate(lrs):
            assert scalars[f"x/lr{k}"][epoch + 1] == float(np.float32(lr)), (epoch, k)
    batch = images.pop("train_batch")
    assert sorted(batch) == [1 + steps * e for e in range(epochs)], sorted(batch)
    assert all((v["height"], v["width"]) == (1920, 1920) for v in batch.values())
    with_rows = len({r["image_id"] for r in trainer.predictions})
    above = len({r["image_id"] for r in trainer.predictions if r["score"] >= 0.3})
    assert sorted(images) == [f"val_img_{i}" for i in range(1, min(8, with_rows) + 1)], \
        sorted(images)
    assert all(list(v) == [epochs] for v in images.values())
    log(f"[12] TensorBoard event file ({os.path.getsize(path)} bytes, read back and both CRCs "
        f"checked in {read_s:.2f} s): the 8 scalars at steps 1..{epochs}, the LRs equal to "
        f"group_lrs_host, train_batch 1920x1920 at steps {sorted(batch)}, {len(images)} "
        f"val_img_* after the final eval ({with_rows} images with a prediction, {above} "
        f"with one of score 0.3 or more) [{card}]")
    return dict(events=len(events), bytes=os.path.getsize(path), val_images=len(images),
                read_s=read_s)


# the train CLI phase's set: 96 PNG train images beside the eval set, in its
# sizes, from another seed (first 160): three b32 steps an epoch, so that the
# profile window (steps 2-4 of the first epoch) still opens, on one step
TRAIN_SET = dict(n_train=96, seed=1, sizes=EVAL_SET["sizes"])
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


def augmentation_ms(data_path: str, card: str, n: int = 16) -> dict:
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
            "--device", "cuda", "--write_trainbatch_tb"]
    args = train_cli.get_args_parser().parse_args(argv)
    plot_s = []
    plot_train_batch = Trainer.plot_train_batch

    def timed_plot(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return plot_train_batch(self, *a, **k)
        finally:
            plot_s.append(time.perf_counter() - t0)

    Trainer.plot_train_batch = timed_plot
    try:
        with KeepRecorder() as rec:
            t0 = time.perf_counter()
            trainer = train_cli.main(args)
            wall = time.perf_counter() - t0
    finally:
        Trainer.plot_train_batch = plot_train_batch
    weights = os.path.join(args.save_dir, "weights")
    ev_files = [f for f in os.listdir(args.save_dir) if f.startswith("events.out.tfevents.")]
    assert len(ev_files) == 1, ev_files
    tb = tensorboard_check(trainer, os.path.join(args.save_dir, ev_files[0]), t["epochs"], card)
    tb.update(write_s=trainer.tblogger.write_s, plot_train_batch_s=plot_s)
    log(f"[12] TensorBoard host seconds: plot_train_batch {[round(v, 3) for v in plot_s]} "
        f"(16 of 32 tiles, 2560 px resized to 1920), the event writes (PNG encode, CRC-32C, "
        f"write) {trainer.tblogger.write_s:.3f} in all [{card}]")
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
                profile=prof, tiles_visited=walk["tiles_visited"], wall_s=wall, tensorboard=tb,
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
        f"gate {wall:.1f} s (in a child process beside [17]'s and the main process's phases "
        f"[11]-[31], sharing the card and the host); "
        f"{walk['launches']} kernel launches in its evals, the tile walk in "
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
            launches = greedy_nms.launches
    finally:
        learning_gate._eval_ckpt, learning_gate._distill_prestage = eval_ckpt, prestage
    with open(os.path.join(args.out, "gate_result.json")) as f:
        result = json.load(f)
    labels = ("teacher", "in-training", "default", "exact")
    walk = rec.check("[17] distill gate evals", args.n_val, labels=labels)
    assert launches == walk["launches"], \
        f"[17] {launches} kernel launches, {walk['launches']} recorded"
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
        f"{wall:.1f} s (in a child process beside [13]'s and the main process's phases, sharing "
        f"the card and the host); kernel launches: "
        f"{counts['teacher']} in the teacher's eval, "
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


def start_child(tag: str, flag: str, root: str):
    """Start a gate phase in a child process (``chip_smoke.py <flag> <root>
    <result.json>``). The learning gate [13] and the distill gate [17] start
    when group [11] starts and are joined where their results are needed:
    both gates are host-bound (the card idles most of each step) and write
    their own data under ``root``, so their minutes overlap [11]-[31] (and
    [17]'s the later groups) instead of adding to the script's wall time;
    every line of the main process logged while one runs says so. Returns ``(tag, process, result
    path, log path)``."""
    name = flag.strip("-").replace("-", "_")
    out = os.path.join(root, f"{name}_child.json")
    log_path = os.path.join(root, f"{name}_child.log")
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, root, out],
                                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    CHILDREN.append((tag, proc))
    return tag, proc, out, log_path


def kill_children() -> None:
    for _, proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@contextlib.contextmanager
def killing_children():
    """Kill the gates' children if the main process leaves early."""
    try:
        yield
    finally:
        kill_children()


def join_child(child) -> dict:
    """Wait for a gate's child, replay its phase lines, and return its
    result (it asserts the gate's bar and its keeps itself)."""
    tag, proc, out, log_path = child
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=1200)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    SHARED_WITH.add(tag)
    CHILDREN.remove((tag, proc))
    with open(log_path) as f:
        lines = f.read().splitlines()
    for line in lines:
        if line.startswith(tag):
            print(line, flush=True)
    assert rc == 0, f"{tag} the gate's child failed:\n" + "\n".join(lines[-60:])
    log(f"{tag} joined its child after {time.perf_counter() - t0:.1f} s of waiting")
    with open(out) as f:
        return json.load(f)


def gate_child(argv, phase) -> int:
    """A gate's child (``chip_smoke.py --learning-gate|--distill-gate <root>
    <json>``): the gate with its kernel checks, its result written as JSON.
    Every launch of the keep in this process is one of the gate's evals."""
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms

    root, out = argv
    greedy_nms.launches = 0
    result = phase(root, nvidia_smi_line())
    result["counted_launches"] = greedy_nms.launches  # main holds it against "launches"
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


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
    from yolov6_tpu_torch.ops.cuda.nms_kernel import (
        TILE, greedy_nms, greedy_nms_op, greedy_nms_plain,
    )

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
    ms = cuda_ms(lambda: greedy_nms_op(nms_boxes, cand_scores, md, iou, True), iters=20, queue_ahead=True)
    call_ms = cuda_ms(lambda: greedy_nms_op(nms_boxes, cand_scores, md, iou, True), iters=20)
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
    the first 32 images of phase 12's split (both epochs on ATSS, the first
    on the mosaic branch), with one in-training eval of the 64 val images at
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
    draw (``plot_box_and_label``), write (``imwrite``) and the whole
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
                      (mod, "imwrite", mod.imwrite),
                      (mod, "make_infer_fn", mod.make_infer_fn),
                      (cls, "process_image", cls.process_image),
                      (cls, "plot_box_and_label", cls.__dict__["plot_box_and_label"]),
                      (cls, "infer", cls.infer)]
        make = mod.make_infer_fn
        datasets.imread = self._timed("decode", datasets.imread)
        mod.imwrite = self._timed("write", mod.imwrite)
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
    keep (B=1, K=2000 filled, max_det 1000) equal to the plain keep, a JPEG at
    the source's size and a label row for each detection; the steps of the
    loop timed on a second run of each precision; then the learning gate's
    N on its val images, whose detections must find most GT boxes."""
    import glob
    import hashlib
    import statistics

    import numpy as np
    import torch

    from yolov6_tpu_torch.data.image_io import imread
    from yolov6_tpu_torch.ops.cuda.nms_kernel import (
        TILE, greedy_nms, greedy_nms_op, greedy_nms_plain,
    )
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
            drawn = imread(os.path.join(out, "images", f"{stem}.jpg"))
            assert drawn.shape == shape, f"[23] {name} {stem}: JPEG {drawn.shape}, source {shape}"
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
            f"(the cap), {r['kept']} kept, each keep equal to the plain emit-once keep; a JPEG at "
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
    ms = cuda_ms(lambda: greedy_nms_op(boxes, scores, md, iou, True), iters=20, queue_ahead=True)
    call_ms = cuda_ms(lambda: greedy_nms_op(boxes, scores, md, iou, True), iters=20)
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
    (both on ATSS) over phase 22's 32 train images, with one in-training
    eval of the 64 val images at conf 0, its first keep with a candidate
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


def upstream_s_model(dev, seed: int = 44, config: str = "yolov6s.py"):
    """S's train graph (configs/yolov6s.py, or ``config``; 80 classes) with
    weights that serve as the serve phase's do: the convs He-normal, each
    RepVGG block's 1x1 and identity branches zero (the block is then its 3x3
    conv and BN, like a deploy conv), BNs as built, the head's predictions
    spread."""
    import torch

    from yolov6_tpu_torch.models.yolo import build_model

    model = build_model(config_at(config), num_classes=NUM_CLASSES, deploy=False,
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


# phase group 33: export and serving (the .pt2 artifact, artifact eval, ONNX,
# TorchScript, NCNN)
EXPORT_EVAL_IMAGES = 64  # [33b]: the first images of [11]'s val set
ONNX_TOL = dict(atol=5e-4, rtol=1e-4)  # tools/export.py --check's
NCNN_TOL = 2e-4  # tools/export.py --format ncnn --check's, fp32
# [33a]'s child: a fresh interpreter that imports only yolov6_tpu_torch (and
# this script's keep_spy, which imports torch alone), loads
# each .pt2 with load_serving and serves the images through it; argv: the
# images' .npy, then (artifact, outputs' .npz, TF32 on) for each artifact
ARTIFACT_CHILD = r"""
import json, sys
import numpy as np
import torch
from yolov6_tpu_torch.models.end2end import load_serving
from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms, greedy_nms_plain
from chip_smoke import keep_spy

images = torch.from_numpy(np.load(sys.argv[1])).cuda()
for path, out_path, tf32 in zip(*[iter(sys.argv[2:])] * 3):
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32 == "1"
    art = load_serving(path, "cuda")
    greedy_nms.launches = 0
    with keep_spy() as spy:
        out = art.call(images)
    torch.cuda.synchronize()
    launches = greedy_nms.launches
    assert len(spy.calls) == launches, (len(spy.calls), launches)
    boxes, scores, max_det, iou, emit_once, idx, valid = spy.calls[0]
    idx_p, valid_p = greedy_nms_plain(boxes, scores, max_det, iou, emit_once=emit_once)
    for _ in range(3):
        art.call(images)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        art.call(images)
    end.record()
    end.synchronize()
    np.savez(out_path, *[o.cpu().numpy() for o in out])
    print("CHILD " + json.dumps(dict(
        path=path, launches=launches,
        keep_equal=bool(torch.equal(idx, idx_p) and torch.equal(valid, valid_p)),
        max_abs_err=float((idx - idx_p).abs().max()), K=int(boxes.shape[1]),
        kept=int(valid.sum()), call_ms=start.elapsed_time(end) / 10,
        foreign=sorted(n for n in sys.modules
                       if n.split(".")[0] in ("jax", "flax", "cv2", "yolov6_tpu")))))
"""


def artifact_phase(model, images_np, images, root: str, dev, card: str) -> dict:
    """Phase 33a: S (phase 3's weights) exported end2end as a ``.pt2`` b32@640
    (uint8 input, preprocessing in the graph) in bf16 and in fp32, each
    loaded with ``load_serving`` in a fresh ``python3 -c`` that imports only
    yolov6_tpu_torch: the kernel launched from inside the artifact (counted
    there), its first keep equal to the plain keep on the artifact's own
    candidates; the fp32 detections equal in count and class to the live
    fp32 serve's (TF32 off on both sides), boxes within 1e-4 of the box
    scale (IMG) and scores within 1e-4; the bf16 ones against the live bf16
    serve within the decode tolerances (DECODE_BOX_TOL, DECODE_SCORE_TOL);
    the artifact's call and the live serve's timed with CUDA events."""
    import numpy as np
    import torch

    from yolov6_tpu_torch.models.end2end import (
        export_program, export_serve_module, make_end2end_fn,
    )

    images_path = os.path.join(root, "serve_images.npy")
    np.save(images_path, images_np)
    names = {"export_s_pt2": True, "export_s_pt2_fp32": False}  # name -> bf16
    argv, export_s = [images_path], {}
    for name, half in names.items():
        path = os.path.join(root, f"{name}.pt2")
        t0 = time.perf_counter()
        export_program(export_serve_module(model, **SERVE, with_preprocess=True, half=half),
                       BATCH, (IMG, IMG), path, input_dtype=torch.uint8)
        export_s[name] = time.perf_counter() - t0
        # fp32 compares without TF32 on both sides
        argv += [path, os.path.join(root, f"{name}.npz"), str(int(half))]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", ARTIFACT_CHILD, *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    child_s = time.perf_counter() - t0
    assert res.returncode == 0, f"[33a] the child failed:\n{res.stderr[-4000:]}"
    children = [json.loads(line[len("CHILD "):]) for line in res.stdout.splitlines()
                if line.startswith("CHILD ")]
    assert len(children) == len(names), res.stdout[-4000:]
    out = {}
    for (name, half), child in zip(names.items(), children):
        assert child["foreign"] == [], f"[33a] the child imported {child['foreign']}"
        assert child["launches"] >= 1, f"[33a] {name}: the artifact launched no NMS kernel"
        assert child["keep_equal"], f"[33a] {name}: the artifact's keep differs from the plain keep"
        got = [torch.from_numpy(a) for a in np.load(os.path.join(root, f"{name}.npz")).values()]
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = half
        live = make_end2end_fn(model, **SERVE, with_preprocess=True, half=half, device=dev)
        want = [t.cpu() for t in live(images)]
        live_ms = cuda_ms(lambda: live(images), iters=10, warmup=3)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        assert torch.equal(got[0], want[0]), f"[33a] {name}: num_dets differ from the live serve"
        valid = torch.arange(SERVE["max_det"])[None] < want[0]
        assert int(valid.sum()) > 0, f"[33a] {name}: no detections"
        assert torch.equal(got[3][valid], want[3][valid]), f"[33a] {name}: classes differ"
        box_tol, score_tol = ((DECODE_BOX_TOL, DECODE_SCORE_TOL) if half else
                              (dict(rtol=0.0, atol=1e-4 * IMG), dict(rtol=0.0, atol=1e-4)))
        box_err = float((got[1][valid] - want[1][valid]).abs().max())
        score_err = float((got[2][valid] - want[2][valid]).abs().max())
        torch.testing.assert_close(got[1][valid], want[1][valid], **box_tol)
        torch.testing.assert_close(got[2][valid], want[2][valid], **score_tol)
        path = child["path"]
        log(f"[33a] {name}: exported b{BATCH}@{IMG} {'bf16' if half else 'fp32'} in "
            f"{export_s[name]:.2f} s ({os.path.getsize(path) / 2**20:.1f} MiB); in the child "
            f"({child_s:.2f} s for both: load_serving, serve, checks, timing), "
            f"{child['launches']} NMS kernel launch(es) "
            f"a call from inside the artifact, the keep (K={child['K']}, {child['kept']} kept) "
            f"equal to the plain keep; {int(valid.sum())} detections as the live serve's, boxes "
            f"max |diff| {box_err:.3e} px, scores {score_err:.3e}; artifact call "
            f"{child['call_ms']:.3f} ms vs live serve {live_ms:.3f} ms [{card}]")
        out[name] = dict(launches=child["launches"], max_abs_err=child["max_abs_err"],
                         K=child["K"], kept=child["kept"], call_ms=child["call_ms"],
                         live_serve_ms=live_ms, export_s=export_s[name], box_err=box_err,
                         score_err=score_err)
    return out


def artifact_eval_phase(model, train_data: str, root: str, dev, card: str) -> dict:
    """Phase 33b: S exported end2end as a ``.pt2`` at the eval protocol
    (float input, multi-label, 8192 candidates) at b32, evaluated by
    ``Evaler.init_artifact`` over the first EXPORT_EVAL_IMAGES images of
    [11]'s val set in fp32 (TF32 off): its COCO rows and AP equal to the
    live Evaler's on the same model and images, one kernel launch a batch
    from inside the artifact, the first equal to the plain keep."""
    import torch

    from yolov6_tpu_torch.core.evaler import Evaler
    from yolov6_tpu_torch.models.end2end import export_program, export_serve_module
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov6_tpu_torch.utils.data_config import load_data_config

    data = load_data_config(val_subset(root, EXPORT_EVAL_IMAGES, train_data))
    path = os.path.join(root, "eval_s.pt2")
    t0 = time.perf_counter()
    export_program(export_serve_module(
        model, conf_thres=EVAL["conf_thres"], iou_thres=EVAL["iou_thres"],
        max_det=EVAL["max_det"], half=False, multi_label=True, max_nms=EVAL["max_nms"]),
        BATCH, (IMG, IMG), path, input_dtype=torch.float32)
    export_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = False
    try:
        kw = dict(batch_size=BATCH, img_size=IMG, half=False, conf_thres=EVAL["conf_thres"],
                  iou_thres=EVAL["iou_thres"], max_det=EVAL["max_det"], max_nms=EVAL["max_nms"],
                  save_dir=root, device=dev)
        live = Evaler(dict(data), **kw)
        live.init_model(model)
        loader = live.init_data(None, "val")
        want = live.predict_model(model, loader)
        want_ap = live.eval_model(want, model, loader)
        art = Evaler(dict(data), **kw)
        shim = art.init_artifact(path, num_classes=NUM_CLASSES)
        greedy_nms.launches = 0
        t0 = time.perf_counter()
        with keep_spy(limit=1) as spy:  # it costs a Python call an op; the log says so
            got = art.predict_model(shim, art.init_data(None, "val"))
        art_s = time.perf_counter() - t0
        launches = greedy_nms.launches
        boxes, scores, max_det, iou, emit_once, idx, valid = spy.calls[0]
        idx_p, valid_p = greedy_nms_plain(boxes, scores, max_det, iou, emit_once=emit_once)
        got_ap = art.eval_model(got, shim, loader)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    n_batches = -(-EXPORT_EVAL_IMAGES // BATCH)
    assert launches == n_batches, f"[33b] {launches} kernel launches for {n_batches} batches"
    assert torch.equal(idx, idx_p) and torch.equal(valid, valid_p), \
        "[33b] the artifact's first keep differs from the plain keep"
    assert len(want) > 0, "[33b] the live Evaler found no detection"
    assert got == want, f"[33b] the artifact's COCO rows differ from the live Evaler's"
    assert tuple(got_ap[:2]) == tuple(want_ap[:2])
    log(f"[33b] Evaler.init_artifact on S's eval-protocol .pt2 (exported in {export_s:.2f} s) "
        f"over {EXPORT_EVAL_IMAGES} images of [11]'s set, fp32 (TF32 off): {len(got)} COCO rows "
        f"equal to the live Evaler's, AP50 {got_ap[0]:.4f} AP {got_ap[1]:.4f} as the live "
        f"model's, {launches} kernel launches from inside the artifact, predict "
        f"{art_s:.2f} s ({EXPORT_EVAL_IMAGES / art_s:.1f} imgs/s) [{card}]")
    return dict(launches=launches, rows=len(got), ap50=float(got_ap[0]), export_s=export_s,
                imgs_per_s=EXPORT_EVAL_IMAGES / art_s,
                max_abs_err=float((idx - idx_p).abs().max()))


def onnx_phase(model, images, ptq, onnx_path: str, dev, card: str) -> dict:
    """Phase 33c: S's fp32 ONNX file (dynamic batch; written to ``onnx_path``
    for [37c]) through ``OnnxTorchModule``
    on the card at b32 against the live fp32 forward plus decode (TF32 off),
    within ONNX_TOL; the same file once through the numpy runner at B=1;
    then [32]'s PTQ S (``ptq``: its deploy model with fake-quantised weights
    and its ranges) as a QDQ file through ``OnnxTorchModule`` against the
    fake-quantised forward plus decode."""
    import torch

    from yolov6_tpu_torch.export.onnx_export import SENTINEL, export_onnx, make_dynamic_batch
    from yolov6_tpu_torch.export.onnx_numpy import OnnxRunner
    from yolov6_tpu_torch.export.onnx_proto import parse_model
    from yolov6_tpu_torch.export.onnx_quant import encode_parsed, to_qdq
    from yolov6_tpu_torch.export.torch_export import DeployForward, OnnxTorchModule
    from yolov6_tpu_torch.quant.state import quant_mode

    x = images.float() / 255.0
    fwd = DeployForward(model).eval()
    t0 = time.perf_counter()
    data = export_onnx(fwd, (x,), input_names=["images"], output_names=["outputs"],
                       dynamic_batch=True)
    m = parse_model(data)
    make_dynamic_batch(m, SENTINEL)
    data = encode_parsed(m)
    export_s = time.perf_counter() - t0
    with open(onnx_path, "wb") as f:
        f.write(data)
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = fwd(x)
            got = OnnxTorchModule(data)(x)
        torch.testing.assert_close(got, want, **ONNX_TOL)
        err = float((got - want).abs().max())
        t0 = time.perf_counter()
        got_np = OnnxRunner(data)(x[:1].cpu().numpy())[0]
        numpy_s = time.perf_counter() - t0
        torch.testing.assert_close(torch.from_numpy(got_np), want[:1].cpu(), **ONNX_TOL)
        np_err = float((torch.from_numpy(got_np) - want[:1].cpu()).abs().max())
        qmodel, amax = ptq
        qfwd = DeployForward(qmodel).eval()
        t0 = time.perf_counter()
        with quant_mode(qmodel, amax):
            qdq = to_qdq(export_onnx(qfwd, (x,), input_names=["images"],
                                     output_names=["outputs"]))
            with torch.no_grad():
                qwant = qfwd(x)
        qdq_s = time.perf_counter() - t0
        with torch.no_grad():
            qgot = OnnxTorchModule(qdq)(x)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    ops = [n.op_type for n in parse_model(qdq).nodes]
    assert ops.count("QuantizeLinear") == len(amax), "[33c] a quantised conv input not rewritten"
    torch.testing.assert_close(qgot, qwant, **ONNX_TOL)
    q_err = float((qgot - qwant).abs().max())
    log(f"[33c] S's ONNX file (dynamic batch; {len(m.nodes)} nodes, exported and converted in "
        f"{export_s:.2f} s) through OnnxTorchModule on the card at b{BATCH}@{IMG} fp32 (TF32 "
        f"off): max |diff| {err:.3e} vs the live forward plus decode (tolerance {ONNX_TOL}); the "
        f"numpy runner at B=1 in {numpy_s:.2f} s: max |diff| {np_err:.3e}; [32]'s PTQ S as QDQ "
        f"({ops.count('QuantizeLinear')} activation QDQ pairs, exported in {qdq_s:.2f} s) "
        f"through OnnxTorchModule: every output within the tolerance of the fake-quantised "
        f"forward, max |diff| {q_err:.3e} [{card}]")
    return dict(max_abs_err=err, numpy_b1_err=np_err, numpy_b1_s=numpy_s, export_s=export_s,
                qdq_max_abs_err=q_err, qdq_export_s=qdq_s)


def torchscript_ncnn_phase(model, images, root: str, dev, card: str) -> dict:
    """Phase 33d: S traced (``export_torchscript``), saved, loaded and run on
    the card at b32 (fp32, TF32 off) against the live forward plus decode
    (ONNX_TOL); Lite-S ([26]'s seeded weights) emitted as NCNN files, run by
    the numpy executor at 320 against the card's Lite-S head maps (fp32)."""
    import numpy as np
    import torch

    from yolov6_tpu_torch.export.ncnn_export import export_ncnn
    from yolov6_tpu_torch.export.ncnn_numpy import NcnnRunner
    from yolov6_tpu_torch.export.torch_export import DeployForward, export_torchscript

    x = images.float() / 255.0
    path = os.path.join(root, "s.torchscript.pt")
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        export_torchscript(model, (x,), path)
        loaded = torch.jit.load(path, map_location=dev)
        with torch.no_grad():
            got, want = loaded(x), DeployForward(model)(x)
        ts_s = time.perf_counter() - t0
        torch.testing.assert_close(got, want, **ONNX_TOL)
        ts_err = float((got - want).abs().max())
        lite = deploy_model(lite_config("s"), 30, dev)
        t0 = time.perf_counter()
        param, bin_path = export_ncnn(lite, os.path.join(root, "lite_s"), fp16=False)
        img = np.random.default_rng(0).uniform(0, 1, (LITE_IMG, LITE_IMG, 3)).astype(np.float32)
        blobs = NcnnRunner(param, bin_path)(img.transpose(2, 0, 1))
        ncnn_s = time.perf_counter() - t0
        with torch.no_grad():
            head, _ = lite(torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).to(dev))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    ncnn_err = 0.0
    for i, (cls, reg) in enumerate(zip(head["cls"], head["reg"])):
        want_i = torch.cat([torch.sigmoid(cls[0]), reg[0]], 0).cpu().numpy()
        np.testing.assert_allclose(blobs[f"out{i}"], want_i, rtol=NCNN_TOL, atol=NCNN_TOL)
        ncnn_err = max(ncnn_err, float(np.abs(blobs[f"out{i}"] - want_i).max()))
    log(f"[33d] S traced to TorchScript, loaded and run on the card b{BATCH}@{IMG} fp32 in "
        f"{ts_s:.2f} s: max |diff| {ts_err:.3e} vs the live forward plus decode "
        f"({'bit-equal' if torch.equal(got, want) else 'not bit-equal'}); Lite-S's NCNN files "
        f"({os.path.getsize(bin_path) / 2**20:.2f} MiB fp32) emitted and run by the numpy "
        f"executor at {LITE_IMG} in {ncnn_s:.2f} s: max |diff| {ncnn_err:.3e} vs the card's "
        f"head maps (tolerance {NCNN_TOL}) [{card}]")
    return dict(torchscript_max_abs_err=ts_err, torchscript_s=ts_s, ncnn_max_abs_err=ncnn_err,
                ncnn_s=ncnn_s)


def ptq_model(kept, amax, dev):
    """[32]'s PTQ S: the folded RepOpt S of yolov6s_opt_qat.py with its conv
    weights fake-quantised per channel, and its ranges."""
    from yolov6_tpu_torch.layers.reparam import fold_to_deploy
    from yolov6_tpu_torch.models.yolo import build_model
    from yolov6_tpu_torch.quant.ptq import quantize_variables

    model = build_model(config_at("repopt", "yolov6s_opt_qat.py"), num_classes=NUM_CLASSES,
                        deploy=True, device=dev)
    model.load_state_dict(fold_to_deploy(kept["ema"], model), strict=True)
    model.load_state_dict(quantize_variables(model.state_dict(), model), strict=True)
    return model, amax


# phase 34: data parallel on the one card. A process group needs processes
# of its own, so each rank is a child (``chip_smoke.py --ddp-step|--ddp-cli
# <root> <rank> <world>``, ``--ddp-nccl <root>``); the two gloo ranks share
# cuda:0 and gloo stages every collective through the host, so [34a]'s ms a
# step is no speed figure. [34a] holds the ranks' step to the one-process
# step at the global batch with the JAX SPMD contract's tolerances
# (tests/test_train_step_spmd_modes.py): the step-0 loss within rtol 1e-4,
# the parameters after step 0 and the BN running statistics after step 0
# and after the last step within rtol 2e-3 and atol 1e-6 of each element,
# the loss trajectory within rtol 2e-3. Step 0 is a warmup step that moves
# only the biases (the weights' and BN weights' learning rate starts at 0);
# steps 1-2 move every group, and each group's update over them is held by
# the contract's norm-ratio and cosine detectors (the elements beyond the
# per-element tolerance at the end are counted and printed)
DDP = dict(world=2, steps=3, loss_rtol=1e-4, rtol=2e-3, atol=1e-6, traj_rtol=2e-3,
           cli_epochs=2, cli_n=64, cli_batch=32, timeout=600)


def ddp_cell_step(dev, half: bool):
    """[6]'s cell, S's train form (He-normal convs from seed 0, as built from
    seed 0 otherwise), the bench's solver and data at the global batch: returns
    the step and the images and targets of the global batch."""
    import torch

    from yolov6_tpu_torch.core.train_step import make_train_step
    from yolov6_tpu_torch.solver.build import scale_hyperparams_for_batch
    from yolov6_tpu_torch.utils.config import Config

    t = TRAIN
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "yolov6s.py"))
    sol = cfg.solver
    torch.manual_seed(0)  # the head's init draws from the default generator
    model, loss_fn, _ = recipe_step(cfg, None, dev, torch.Generator(device=dev).manual_seed(0),
                                    t["epochs"])
    solver = scale_hyperparams_for_batch(dict(
        lr0=sol.lr0, lrf=sol.lrf, momentum=sol.momentum, weight_decay=sol.weight_decay,
        warmup_epochs=sol.warmup_epochs, warmup_momentum=sol.warmup_momentum,
        warmup_bias_lr=sol.warmup_bias_lr, lr_scheduler="Cosine"), BATCH)
    step = make_train_step(model, loss_fn, solver, t["max_stepnum"], t["epochs"], BATCH,
                           t["warmup_stepnum"], (IMG, IMG), half=half, device=dev)
    images, targets = bench_batch(BATCH, IMG, t["max_labels"], t["labels"], dev)
    return step, images, targets


def ddp_steps(step, images, targets) -> dict:
    """``DDP["steps"]`` steps at [6]'s epoch: the losses, ms a step (CUDA
    events around each), the flat parameters before, after step 0 and at the
    end, the BN statistics after step 0 and at the end (CPU copies), and the
    parameter groups' sizes and ids."""
    import torch

    out = dict(losses=[], ms=[], before=step._param.cpu(), group_ids=step._group_ids,
               sizes=[len(g) for g in step._split(step._param)])
    for i in range(DDP["steps"]):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loss, _ = step(images, targets, TRAIN["epoch"])
        b.record()
        b.synchronize()
        out["ms"].append(a.elapsed_time(b))
        out["losses"].append(float(loss))
        if i == 0:
            out["step0"], out["stats0"] = step._param.cpu(), step._stats.cpu()
    out["end"], out["stats_end"] = step._param.cpu(), step._stats.cpu()
    return out


def ddp_start(flag: str, root: str, *argv, env=None) -> tuple:
    """Start the child ``chip_smoke.py <flag> <root> <argv...>``, its output
    to files under ``root`` (no pipe for a rank to block on)."""
    name = os.path.join(root, flag.strip("-") + "".join(f"_{a}" for a in argv))
    out, err = open(name + ".out", "w"), open(name + ".err", "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, root, *argv],
                            stdout=out, stderr=err, text=True, cwd=ROOT, env=env)
    out.close()
    err.close()
    return proc, name


def ddp_wait(children: list, tag: str) -> list:
    """Wait for ``ddp_start``'s children, relay their ``tag`` lines, and raise
    if any fails; returns their standard outputs."""
    failed, outs = [], []
    for proc, name in children:
        try:
            proc.wait(timeout=DDP["timeout"])
        except subprocess.TimeoutExpired:
            for p, _ in children:
                p.kill()
            proc.wait()
        with open(name + ".out") as f:
            out = f.read()
        outs.append(out)
        for line in out.splitlines():
            if line.startswith(tag):
                log(line)
        if proc.returncode != 0:
            with open(name + ".err") as f:
                print(out[-4000:] + f.read()[-8000:], file=sys.stderr)
            failed.append(os.path.basename(name))
    if failed:
        raise RuntimeError(f"{tag} children {failed} failed")
    return outs


def ddp_join(root: str, name: str, rank: int, world: int):
    """The gloo group ``name`` of the children, through a file under ``root``."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, name + '.store')}",
                            rank=rank, world_size=world)
    torch.cuda.set_device(0)


def ddp_step_child(argv) -> int:
    """[34a]'s rank: the cell's step on its half of the global batch, fp32
    with TF32 off, in the gloo group; saves its results under ``root``."""
    import torch
    import torch.distributed as dist

    from yolov6_tpu_torch.layers.sync_bn import SyncBatchNorm
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.parallel.dist import broadcast_

    root, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ddp_join(root, "ddp_step", rank, world)
    dev = torch.device("cuda")
    step, images, targets = ddp_cell_step(dev, half=False)
    n_sync = sum(type(m) is SyncBatchNorm for m in step.model.modules())
    assert n_sync > 100, f"{n_sync} synchronised BatchNorms"
    per = BATCH // world
    part = slice(rank * per, (rank + 1) * per)
    greedy_nms.launches = 0
    out = ddp_steps(step, images[part].contiguous(), targets[part].contiguous())
    out.update(launches=greedy_nms.launches, n_sync=n_sync)
    # every rank holds rank 0's state, bit for bit
    for name, flat in (("params", step._param), ("stats", step._stats), ("ema", step._ema[0])):
        ref = flat.clone()
        broadcast_(ref)
        out[f"same_{name}"] = bool(torch.equal(ref, flat))
    log(f"[34a] rank {rank}: {DDP['steps']} steps of b{per}@{IMG} fp32 (TF32 off), "
        f"{n_sync} synchronised BatchNorms, ms a step {[round(v, 1) for v in out['ms']]} "
        f"(gloo through the host, two ranks on one card: no speed figure)")
    if rank == 0:
        torch.save(out, os.path.join(root, "ddp_step_rank0.pt"))
    else:
        torch.save({k: out[k] for k in ("losses", "ms", "launches", "n_sync", "same_params",
                                        "same_stats", "same_ema")},
                   os.path.join(root, f"ddp_step_rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def ddp_one_process(dev) -> dict:
    """[34a]'s reference: the one-process step at b32, fp32 with TF32 off."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        step, images, targets = ddp_cell_step(dev, half=False)
        one = ddp_steps(step, images, targets)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del step, images, targets
    torch.cuda.empty_cache()
    return one


def ddp_step_phase(root: str, one: dict, wall: float, card: str) -> dict:
    """[34a]: the two gloo ranks' results (b16 each, children that have
    ended after ``wall`` s) held to the one-process step ``one``."""
    import torch

    world = DDP["world"]
    ranks = [torch.load(os.path.join(root, f"ddp_step_rank{r}.pt"), weights_only=False)
             for r in range(world)]
    r0 = ranks[0]
    for r in ranks:
        assert r["same_params"] and r["same_stats"] and r["same_ema"], "the ranks' states differ"
        assert r["losses"] == r0["losses"] and r["launches"] == 0
    assert torch.equal(r0["before"], one["before"]), "the ranks started from other weights"
    assert all(math.isfinite(v) for v in one["losses"] + r0["losses"])
    loss_err = abs(r0["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    assert loss_err <= DDP["loss_rtol"], f"[34a] step-0 loss {r0['losses'][0]} vs {one['losses'][0]}"
    traj = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"]))
    assert traj <= DDP["traj_rtol"], f"[34a] loss trajectory {r0['losses']} vs {one['losses']}"

    def beyond(got, want):
        """How many elements lie beyond rtol 2e-3 / atol 1e-6, and by how much."""
        excess = (got - want).abs() - (DDP["atol"] + DDP["rtol"] * want.abs())
        return int((excess > 0).sum()), float(excess.max())

    # each group's update over steps 1-2 (step 0 moves the biases only): the
    # contract's chaos detectors, and how many elements lie beyond tolerance
    names = {0: "BN weights", 1: "weights", 2: "biases"}
    groups = {}
    parts = [t.split(r0["sizes"]) for t in (one["step0"], one["end"], r0["step0"], r0["end"])]
    for g, a0, a1, b0, b1 in zip(r0["group_ids"], *parts):
        u_one, u_two = (a1 - a0).double(), (b1 - b0).double()
        n_beyond, excess = beyond(b1, a1)
        groups[names[g]] = dict(
            n=len(a1), n_beyond=n_beyond, excess=excess,
            update_ratio=float(u_two.norm() / u_one.norm()),
            update_cos=float(u_one @ u_two / (u_one.norm() * u_two.norm())),
            diff_over_update=float((u_two - u_one).norm() / u_one.norm()),
            max_diff=float((b1 - a1).abs().max()), max_update=float(u_one.abs().max()))
    held = {what: beyond(r0[key], one[key]) for key, what in (
        ("step0", "parameters after step 0"), ("stats0", "BN statistics after step 0"),
        ("stats_end", "BN statistics at the end"))}
    diff0 = float((r0["step0"] - one["step0"]).abs().max())
    log(f"[34a] 2 gloo ranks (b{BATCH // world} each, {r0['n_sync']} synchronised BatchNorms) "
        f"against one process at b{BATCH}, S train form at [6]'s cell in fp32 (TF32 off): "
        f"step-0 loss {r0['losses'][0]:.6f} vs {one['losses'][0]:.6f} (rel {loss_err:.2e}), "
        f"losses {[round(v, 5) for v in r0['losses']]} (trajectory rel {traj:.2e}); elements "
        f"beyond rtol 2e-3 / atol 1e-6: " + ", ".join(f"{what} {n}" for what, (n, _) in
                                                      held.items())
        + f" (largest parameter difference after step 0 {diff0:.3e}); each group's update "
        f"over steps 1-2: " + "; ".join(
            f"{k} ({v['n']}): norm ratio {v['update_ratio']:.6f}, cosine {v['update_cos']:.6f}, "
            f"|difference| / |update| {v['diff_over_update']:.3e}, largest difference "
            f"{v['max_diff']:.3e} of largest update {v['max_update']:.3e}, {v['n_beyond']} "
            f"elements at the end beyond rtol 2e-3 / atol 1e-6 (by up to {v['excess']:.3e})"
            for k, v in groups.items())
        + f"; the ranks' states bit-equal; ms a step: one process "
        f"{[round(v, 1) for v in one['ms']]}, ranks {[round(v, 1) for v in r0['ms']]}; "
        f"children {wall:.1f} s [{card}]")
    for what, (n_beyond, excess) in held.items():
        assert n_beyond == 0, (f"[34a] {what}: {n_beyond} elements beyond rtol 2e-3 / atol "
                               f"1e-6, by up to {excess:.3g}")
    for k, v in groups.items():
        assert v["max_update"] > 0, f"[34a] steps 1-2 did not move the {k}"
        assert 0.93 < v["update_ratio"] < 1.07 and v["update_cos"] > 0.98, f"[34a] {k}: {v}"
    return dict(launches=sum(r["launches"] for r in ranks), loss_rel=loss_err, traj_rel=traj,
                groups=groups, one_ms=one["ms"], rank_ms=r0["ms"], n_sync=r0["n_sync"],
                children_wall_s=wall)


def record_writes(root: str) -> list:
    """Record every write-mode ``open``, ``os.makedirs`` and ``os.replace``
    under ``root`` made by this process from now on."""
    import builtins

    writes = []
    real_open, real_makedirs, real_replace = builtins.open, os.makedirs, os.replace

    def under(path):
        return isinstance(path, (str, os.PathLike)) and \
            os.path.abspath(os.fspath(path)).startswith(root)

    def open_(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+") and under(file):
            writes.append(("open", os.fspath(file)))
        return real_open(file, mode, *a, **k)

    def makedirs(name, *a, **k):
        if under(name):
            writes.append(("makedirs", os.fspath(name)))
        return real_makedirs(name, *a, **k)

    def replace(src, dst, *a, **k):
        if under(dst):
            writes.append(("replace", os.fspath(dst)))
        return real_replace(src, dst, *a, **k)

    builtins.open, os.makedirs, os.replace = open_, makedirs, replace
    return writes


def ddp_cli_argv(root: str) -> list:
    """[34b]'s train CLI arguments; the parent writes the config copy and the
    subsets before the ranks start, and the ranks only read them."""
    conf = os.path.join(root, "yolov6s_ddp_cli.py")
    if not os.path.exists(conf):
        cli_config(root, os.path.join(ROOT, "configs", "yolov6s.py"), "yolov6s_ddp_cli.py")
    data_path = val_subset(root, DDP["cli_n"], train_subset(root, DDP["cli_n"]))
    return ["--data-path", data_path, "--conf-file", conf, "--img-size", str(IMG),
            "--batch-size", str(DDP["cli_batch"]), "--epochs", str(DDP["cli_epochs"]),
            "--workers", "4", "--eval-final-only", "--stop_aug_last_n_epoch", "1",
            "--cache", "disk", "--output-dir", os.path.join(root, "train_ddp"), "--name", "s",
            "--bf16", "--log-interval", "1", "--seed", "0", "--device", "cuda"]


def ddp_cli_child(argv) -> int:
    """[34b]'s rank: ``tools/train.py::main`` in the gloo group, its keep
    launches counted and its first keep with a candidate held against the
    plain keep; saves its results under ``root``."""
    import torch

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.tools import train as train_cli

    root, rank, world = argv[0], int(argv[1]), int(argv[2])
    ddp_join(root, "ddp_cli", rank, world)
    args = train_cli.get_args_parser().parse_args(ddp_cli_argv(root))
    writes = record_writes(os.path.abspath(args.output_dir)) if rank else None
    greedy_nms.launches = 0
    with KeepRecorder() as rec:
        t0 = time.perf_counter()
        trainer = train_cli.main(args)
        wall = time.perf_counter() - t0
    launches = greedy_nms.launches
    n_shard = len(trainer.val_loader._indices())
    walk = rec.check(f"[34b] rank {rank}'s in-training eval", n_shard)
    assert launches == walk["launches"] == -(-n_shard // trainer.val_loader.batch_size)
    stats = trainer.epoch_stats
    assert all(math.isfinite(v) for e in stats for v in e["mean_loss"]), stats
    cache = trainer.train_loader.dataset
    out = dict(launches=launches, max_abs_err=walk["max_abs_err"], n_shard=n_shard,
               results=trainer.evaluate_results, save_dir=trainer.save_dir, writes=writes,
               epochs=stats, wall_s=wall, cache=cache.cache,
               cache_files=len(os.listdir(cache.disk_cache_dir)),
               predictions=trainer.predictions if rank == 0 else None)
    log(f"[34b] rank {rank}: {len(stats)} epochs of b{args.batch_size // world}@{IMG} bf16 "
        f"(--cache disk, {out['cache_files']} images in the shared tier), steps "
        f"{[e['steps'] for e in stats]}, {[round(e['imgs_per_s'], 1) for e in stats]} imgs/s a "
        f"rank; eval of its {n_shard} val images: {launches} keep launches on its device, the "
        f"first keep with a candidate (K {walk['first']['eval']['boxes'].shape[1]}) equal to "
        f"the plain keep; AP50 {trainer.evaluate_results[0]:.5f}; {wall:.1f} s")
    torch.save(out, os.path.join(root, f"ddp_cli_rank{rank}.pt"))
    return 0


def ddp_cli_phase(root: str, wall: float, dev, card: str) -> dict:
    """[34b]: the train CLI's two gloo ranks on the card (children that have
    ended after ``wall`` s); rank 0's gathered rows held, row for row,
    against a one-process Evaler on the run's EMA."""
    import torch

    from yolov6_tpu_torch.core.evaler import Evaler
    from yolov6_tpu_torch.models.yolo import build_model
    from yolov6_tpu_torch.utils.checkpoint import load_checkpoint
    from yolov6_tpu_torch.utils.config import Config
    from yolov6_tpu_torch.utils.data_config import load_data_config

    world = DDP["world"]
    argv = ddp_cli_argv(root)
    ranks = [torch.load(os.path.join(root, f"ddp_cli_rank{r}.pt"), weights_only=False)
             for r in range(world)]
    r0, r1 = ranks
    assert r1["writes"] == [], f"[34b] rank 1 wrote {r1['writes'][:4]}"
    events = [f for f in os.listdir(r0["save_dir"]) if f.startswith("events.out.tfevents.")]
    assert len(events) == 1, f"[34b] event files: {events}"
    out_dir = os.path.join(root, "train_ddp")
    assert os.listdir(out_dir) == ["s"] and r0["save_dir"] == r1["save_dir"]
    weights = os.path.join(r0["save_dir"], "weights")
    assert {"last_ckpt.pt", "best_ckpt.pt"} <= set(os.listdir(weights))
    assert r0["results"] == r1["results"], "the ranks hold other APs"
    assert sum(r["n_shard"] for r in ranks) == DDP["cli_n"]
    assert all(r["cache"] == "disk" and 0 < r["cache_files"] <= DDP["cli_n"] for r in ranks)

    args = dict(zip(argv[::2], argv[1::2]))
    cfg = Config.fromfile(args["--conf-file"])
    model = build_model(cfg, NUM_CLASSES, deploy=False, device=dev)
    model.load_state_dict(load_checkpoint(os.path.join(weights, "last_ckpt.pt"))["model"],
                          strict=True)
    evaler = Evaler(load_data_config(args["--data-path"]), batch_size=DDP["cli_batch"] // world,
                    img_size=IMG, conf_thres=TRAIN_CLI_EVAL["conf_thres"], iou_thres=0.65,
                    device=dev)
    evaler.init_model(model)
    with KeepRecorder() as rec:
        rows = evaler.predict_model(model, evaler.init_data(None, "val"), task="train")
    walk = rec.check("[34b] one-process Evaler", DDP["cli_n"])
    assert len(rows) > 0 and len(r0["predictions"]) == len(rows)
    assert r0["predictions"] == rows, "[34b] rank 0's gathered rows differ from one process's"
    log(f"[34b] tools/train.py::main in 2 gloo ranks on the card (global b{DDP['cli_batch']}, "
        f"{DDP['cli_epochs']} epochs over {DDP['cli_n']} train images, --cache disk): each rank "
        f"launched the keep on its device ({r0['launches']} + {r1['launches']}), each first keep "
        f"equal to the plain keep; rank 0's {len(rows)} gathered COCO rows equal, row for row, a "
        f"one-process Evaler's on the run's EMA ({walk['launches']} launches); both ranks hold "
        f"AP50 {r0['results'][0]:.5f}, AP {r0['results'][1]:.5f}; only rank 0 wrote the run, its "
        f"one TensorBoard event file included; "
        f"children {wall:.1f} s [{card}]")
    return dict(launches_rank0=r0["launches"], launches_rank1=r1["launches"],
                evaler_launches=walk["launches"], rows=len(rows), results=r0["results"],
                epochs=[r["epochs"] for r in ranks], children_wall_s=wall,
                max_abs_err=max(r0["max_abs_err"], r1["max_abs_err"], walk["max_abs_err"]))


def ddp_nccl_child(argv) -> int:
    """[34c]: [6]'s step (bf16) twice without a process group, then once in
    an NCCL group of one, whose collectives run (the parameters' broadcast,
    the loss normalisers' and the gradient's sums) and change no value;
    prints whether each equals the first bit for bit, and whether the
    helpers give back what they were given under NCCL: rows gathered from
    the host, a sum of a host tensor (staged through the card) and an
    object broadcast through the card."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.parallel.dist import (
        all_gather_rows, all_reduce_sum_, broadcast_object, initialize_distributed, world_size,
    )

    root = argv[0]
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda")

    def run():
        step, images, targets = ddp_cell_step(dev, half=True)
        loss, comp = step(images, targets, TRAIN["epoch"])
        state = step.state_dict()
        ema = {k: v.cpu() for k, v in step.ema.state_dict().items()}
        return state, ema, float(loss)

    greedy_nms.launches = 0
    plain = run()
    again = run()
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(root, 'nccl.store')}",
                            rank=0, world_size=1)
    assert initialize_distributed("cuda") == torch.device("cuda", 0)
    assert dist.get_backend() == "nccl" and world_size() == 1
    nccl = run()
    rows = np.random.default_rng(0).random((300, 7))
    gathered = all_gather_rows(rows)
    host = torch.arange(6.0)
    all_reduce_sum_(host)
    obj = {"ap": (0.5, 0.25), "rows": 300}
    helpers = (len(gathered) == 1 and np.array_equal(gathered[0], rows)
               and torch.equal(host, torch.arange(6.0)) and broadcast_object(obj) == obj)
    dist.destroy_process_group()

    def same(a, b):
        return all(torch.equal(a[0][k], b[0][k]) for k in a[0]) and \
            all(torch.equal(a[1][k], b[1][k]) for k in a[1]) and a[2] == b[2]

    res = dict(repeat_equal=same(plain, again), nccl_equal=same(plain, nccl),
               helpers_equal=helpers, launches=greedy_nms.launches, loss=plain[2])
    log(f"[34c] {json.dumps(res)}")
    return 0


def ddp_phases(root: str, dev, card: str) -> dict:
    """Phase group 34 (see the module doc): [34c]'s child starts first, then
    [34a]'s reference step runs here, then [34a]'s and [34b]'s ranks run side
    by side (no time of theirs is a claim), and the results are checked as
    each group ends."""
    world = DDP["world"]
    nccl = [ddp_start("--ddp-nccl", root, env=dict(os.environ,
                                                   CUBLAS_WORKSPACE_CONFIG=":4096:8"))]
    try:
        one = ddp_one_process(dev)
        ddp_cli_argv(root)  # the config copy and the subsets, before the ranks read them
        t0 = time.perf_counter()
        step_ranks = [ddp_start("--ddp-step", root, str(r), str(world)) for r in range(world)]
        cli_ranks = [ddp_start("--ddp-cli", root, str(r), str(world)) for r in range(world)]
        try:
            ddp_wait(step_ranks, "[34a]")
            step = ddp_step_phase(root, one, time.perf_counter() - t0, card)
        finally:
            ddp_wait(cli_ranks, "[34b]")
        cli = ddp_cli_phase(root, time.perf_counter() - t0, dev, card)
    finally:
        out, = ddp_wait(nccl, "[34c] [")
    res = json.loads(next(line for line in out.splitlines() if line.startswith("[34c] "))[6:])
    assert res["repeat_equal"], "[34c] the plain step is not reproducible bit for bit"
    assert res["nccl_equal"], "[34c] the step in an NCCL group of one differs from the plain step"
    assert res["helpers_equal"], "[34c] a collective helper under NCCL changed its input"
    assert res["launches"] == 0
    log(f"[34c] [6]'s step (S b{BATCH}@{IMG} bf16) in an NCCL process group of one equals the "
        f"step without a group bit for bit (parameters, statistics, momentum, EMA, counters; "
        f"loss {res['loss']:.6f}), as a second plain step does; the gather of host rows, the "
        f"sum of a host tensor and an object's broadcast through NCCL give back their "
        f"inputs [{card}]")
    return dict(step=step, cli=cli, nccl=res,
                launches=step["launches"] + cli["launches_rank0"] + cli["launches_rank1"])


IMAGE_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_images")
SHAPE_CLI = dict(height=384, width=640, batch=16, n_train=64, n_val=64, workers=8)
# [35b]'s extra train files: the fixture, and what the scan must make of it
SHAPE_CLI_FILES = {"trunc_420.jpg": "restored", "prog_420.jpg": "kept", "rgb16.png": "kept",
                   "palette4.png": "kept"}
REPRO_SET = dict(n_val=16, batch=16)


def image_codec_phase(card: str) -> dict:
    """Phase 35a: the committed fixtures (tests/data/torch_images/: progressive
    and truncated JPEG, 16-bit, palette, grey+alpha, sub-byte and Adam7 PNG,
    1/4/8/16/24/32-bit BMP) decode to the SHA-256 of cv2.imread's pixels,
    written beside them by tests/torch_image_fixtures.py; the demo JPEGs'
    pixels encode to the bytes cv2.imencode writes (their SHA-256) and decode
    back to their shape within the codec's loss."""
    import hashlib

    import numpy as np

    from yolov6_tpu_torch.data import jpeg
    from yolov6_tpu_torch.data.image_io import imread
    from yolov6_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    with open(os.path.join(IMAGE_FIXTURES, "hashes.json")) as f:
        manifest = json.load(f)
    t0 = time.perf_counter()
    jpeg.load()
    jpeg.load_encoder()  # both built by the host g++ at their first use ([23]'s infer CLI)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, want in manifest["images"].items():
        img = imread(os.path.join(IMAGE_FIXTURES, name))
        assert list(img.shape) == want["shape"], f"[35] {name}: {img.shape}, cv2 {want['shape']}"
        assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"], \
            f"[35] {name}: the decode differs from cv2.imread's"
    decode_s = time.perf_counter() - t0
    encoded = {}
    for rel, want in manifest["encoded"].items():
        img = imread(os.path.join(ROOT, rel))
        t0 = time.perf_counter()
        data = encode_jpeg(img)
        ms = (time.perf_counter() - t0) * 1e3
        assert len(data) == want["bytes"] and hashlib.sha256(data).hexdigest() == want["sha256"], \
            f"[35] {rel}: encode_jpeg's bytes differ from cv2.imencode's"
        back = decode_jpeg(data)
        diff = float(np.abs(back.astype(np.int16) - img.astype(np.int16)).mean())
        assert back.shape == img.shape and diff < 3.0, (rel, back.shape, diff)
        encoded[rel] = dict(bytes=len(data), encode_ms=ms, mean_abs_diff=diff)
    log(f"[35] the JPEG decoder and encoder loaded in {build_s:.2f} s; "
        f"{len(manifest['images'])} fixture files (JPEG progressive and cut short, PNG "
        f"16-bit/palette/grey+alpha/sub-byte/Adam7, BMP 1-32-bit) decode to cv2.imread's pixels "
        f"(sha256) in {decode_s * 1e3:.1f} ms; the demo JPEGs encode to cv2.imencode's bytes: "
        + ", ".join(f"{os.path.basename(k)} {v['bytes']} B in {v['encode_ms']:.1f} ms (decoded "
                    f"back within {v['mean_abs_diff']:.2f} levels)" for k, v in encoded.items())
        + f" [{card}]")
    return dict(fixtures=len(manifest["images"]), build_s=build_s, decode_s=decode_s,
                encoded=encoded)


def shape_cli_phase(root: str, card: str) -> dict:
    """Phase 35b: YOLOv6-N (configs/yolov6n.py, its eval at conf 0) through
    ``tools/train.py::main`` at ``--specific-shape --height 384 --width 640
    --check-images --check-labels``, batch 16, 1 epoch in bf16, over [31]'s 64
    train images plus four fixtures (a truncated JPEG, a progressive JPEG, a
    16-bit PNG, a palette PNG), a file of garbage and an image whose labels
    are out of range; the in-training eval of [31]'s 64 val images stays
    square at 640. The garbage is dropped, the truncated JPEG restored in
    place, the out-of-range labels dropped, every step takes 16x384x640, and
    the eval's first keep with a candidate equals the plain keep."""
    import glob
    import shutil

    import numpy as np

    from yolov6_tpu_torch.data.image_io import imread
    from yolov6_tpu_torch.tools import train as train_cli
    from yolov6_tpu_torch.utils.data_config import load_data_config

    t = SHAPE_CLI
    data = load_data_config(val_subset(root, t["n_val"], train_subset(root, t["n_train"])))
    sub = "train_shape"
    img_dir, lb_dir = (os.path.join(root, kind, sub) for kind in ("images", "labels"))
    os.makedirs(img_dir)
    os.makedirs(lb_dir)
    for path in sorted(glob.glob(os.path.join(data["train"], "*.png"))):
        stem = os.path.splitext(os.path.basename(path))[0]
        shutil.copy(path, img_dir)
        shutil.copy(os.path.join(root, "labels", os.path.basename(data["train"]),
                                 f"{stem}.txt"), lb_dir)
    for name in SHAPE_CLI_FILES:
        shutil.copy(os.path.join(IMAGE_FIXTURES, name), img_dir)
    with open(os.path.join(img_dir, "garbage.jpg"), "wb") as f:
        f.write(np.random.default_rng(35).integers(0, 256, 4096, np.uint8).tobytes())
    for name in [*SHAPE_CLI_FILES, "garbage.jpg"]:
        with open(os.path.join(lb_dir, os.path.splitext(name)[0] + ".txt"), "w") as f:
            f.write("0 0.5 0.5 0.4 0.4\n1 0.3 0.3 0.2 0.2\n")
    first_png = sorted(glob.glob(os.path.join(data["train"], "*.png")))[0]
    bad_label = os.path.splitext(os.path.basename(first_png))[0] + ".txt"
    with open(os.path.join(lb_dir, bad_label), "a") as f:
        f.write("2 0.5 1.5 0.2 0.2\n")
    data["train"] = img_dir
    data_path = os.path.join(root, "data80_train_shape.json")
    with open(data_path, "w") as f:
        json.dump(data, f)
    conf = cli_config(root, os.path.join(ROOT, "configs", "yolov6n.py"), "n_shape_cli.py")
    args = train_cli.get_args_parser().parse_args([
        "--data-path", data_path, "--conf-file", conf, "--img-size", str(IMG), "--batch-size",
        str(t["batch"]), "--epochs", "1", "--workers", str(t["workers"]), "--output-dir",
        os.path.join(root, "train"), "--name", "n_shape", "--bf16", "--log-interval", "1",
        "--seed", "0", "--device", "cuda", "--specific-shape", "--height", str(t["height"]),
        "--width", str(t["width"]), "--check-images", "--check-labels"])
    with KeepRecorder() as rec:
        t0 = time.perf_counter()
        trainer = train_cli.main(args)
        wall = time.perf_counter() - t0
    walk = rec.check("[35] N specific-shape in-training eval", t["n_val"])
    ds = trainer.train_loader.dataset
    names = {os.path.basename(p) for p in ds.img_paths}
    assert "garbage.jpg" not in names and set(SHAPE_CLI_FILES) <= names, names
    assert len(ds) == t["n_train"] + len(SHAPE_CLI_FILES)
    restored = os.path.join(img_dir, "trunc_420.jpg")
    with open(restored, "rb") as f:
        assert f.read()[-2:] == b"\xff\xd9", "[35] the truncated JPEG was not restored"
    with open(os.path.join(IMAGE_FIXTURES, "hashes.json")) as f:
        want_shape = tuple(json.load(f)["images"]["trunc_420.jpg"]["shape"])
    assert imread(restored).shape == want_shape
    bad_stem = os.path.splitext(bad_label)[0]
    bad = next(i for i, p in enumerate(ds.img_paths)
               if os.path.splitext(os.path.basename(p))[0] == bad_stem)
    assert len(ds.labels[bad]) == 0, "[35] check_labels kept an out-of-range label file"
    assert trainer.train_step.img_size == (t["height"], t["width"])
    e = trainer.epoch_stats[0]
    assert e["steps"] == len(ds) // t["batch"] and all(math.isfinite(v) for v in e["mean_loss"])
    ev = trainer.eval_stats[-1]
    assert ev["images"] == t["n_val"]
    log(f"[35] train CLI N at --specific-shape {t['height']}x{t['width']} with --check-images "
        f"--check-labels: "
        f"{len(ds)} images kept of {t['n_train'] + len(SHAPE_CLI_FILES) + 1} (garbage.jpg dropped, "
        f"trunc_420.jpg restored, {bad_label}'s labels dropped), {e['steps']} steps of "
        f"b{t['batch']}@{t['height']}x{t['width']} bf16 in {e['wall_s']:.3f} s = "
        f"{e['imgs_per_s']:.1f} imgs/s with "
        f"the loader, step {e['step_ms']:.3f} ms (CUDA events), mean loss "
        f"{[round(v, 5) for v in e['mean_loss']]}; the eval of {ev['images']} images at {IMG}: "
        f"{walk['launches']} keep launches, the first keep with a candidate (K "
        f"{walk['first']['eval']['boxes'].shape[1]}, {walk['first']['eval']['kept']} kept) equal "
        f"to the plain keep; the run {wall:.1f} s [{card}]")
    return dict(launches=walk["launches"], max_abs_err=walk["max_abs_err"],
                tiles_visited=walk["tiles_visited"], kept=len(ds), dropped=["garbage.jpg"],
                restored=["trunc_420.jpg"], labels_dropped=[bad_label], epoch=e, eval=ev,
                wall_s=wall)


def repro_gate_phase(data: dict, root: str, dev, card: str) -> dict:
    """Phase 35c: ``tools/repro_gate.py::main`` on a 16-image COCO-layout set
    (the first 16 of [11]'s val images written as JPEG by ``imwrite``, their
    labels as ``instances_val2017.json`` in COCO's category ids) with an
    upstream-format N ``.pt`` (seeded weights as [31]'s S, through a stub
    ``yolov6`` package): the published protocol (640, shrink 4, K 8192) and
    the exact one (K 30,000, per-anchor top-k rows), every keep equal to the
    plain keep, exit code 1 (random weights fail the 37.5 target) and S
    reported ``SKIP (no weights)``. Returns the N file's path too."""
    import glob

    from yolov6_tpu_torch.data.image_io import imread, imwrite
    from yolov6_tpu_torch.tools import repro_gate
    from yolov6_tpu_torch.utils.coco_eval import coco80_to_coco91_class
    from yolov6_tpu_torch.utils.upstream_ckpt import write_upstream_checkpoint

    t = REPRO_SET
    coco = os.path.join(root, "coco16")
    for part in ("images/val2017", "annotations", "weights"):
        os.makedirs(os.path.join(coco, part))
    coco91 = coco80_to_coco91_class()
    images, anns = [], []
    for i, path in enumerate(sorted(glob.glob(os.path.join(data["val"], "*.png")))[:t["n_val"]]):
        img = imread(path)
        h, w = img.shape[:2]
        name = f"{i + 1:012d}.jpg"
        imwrite(os.path.join(coco, "images", "val2017", name), img)
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
        stem = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(root, "labels", "val", f"{stem}.txt")) as f:
            for line in f:
                c, cx, cy, bw, bh = map(float, line.split())
                anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=coco91[int(c)],
                                 bbox=[(cx - bw / 2) * w, (cy - bh / 2) * h, bw * w, bh * h],
                                 area=bw * w * bh * h, iscrowd=0, segmentation=[]))
    with open(os.path.join(coco, "annotations", "instances_val2017.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=c, name=str(c)) for c in coco91]), f)
    model = upstream_s_model(dev, seed=35, config="yolov6n.py")
    weights = write_upstream_checkpoint(os.path.join(coco, "weights", "yolov6n.pt"), model,
                                        os.path.join(root, "stub_yolov6_n"))
    del model
    out_json = os.path.join(root, "repro_gate.json")
    args = repro_gate.get_args_parser().parse_args([
        "--coco-root", coco, "--weights-dir", os.path.join(coco, "weights"), "--models",
        "yolov6n", "yolov6s", "--batch-size", str(t["batch"]), "--save-dir",
        os.path.join(root, "repro_gate"), "--out-json", out_json, "--device", "cuda"])
    with KeepRecorder(record_all=True) as rec:
        t0 = time.perf_counter()
        code = repro_gate.main(args)
        wall = time.perf_counter() - t0
    launches, err = rec.check_all("[35] repro gate")
    ks = [f["boxes"].shape[1] for f in launches]
    assert ks == [8192, 30000], f"[35] the gate's keeps ran at K {ks}, not 8192 then 30000"
    assert all(bool((f["scores"] > 0).any(1).all()) for f in launches), \
        "[35] an image of the gate had no candidate"
    with open(out_json) as f:
        rows = json.load(f)
    assert code == 1, f"[35] the gate exited {code}, not 1"
    assert rows[0]["model"] == "yolov6n" and rows[0]["status"].startswith("FAIL")
    assert rows[1] == dict(model="yolov6s", map=None, target=45.0, status="SKIP (no weights)",
                           nms_delta=None)
    log(f"[35] repro_gate on {t['n_val']} COCO-layout JPEGs with an upstream-format N .pt: "
        f"keeps at K {ks} (B={t['batch']}), each equal to the plain keep; N mAP50:95 "
        f"{rows[0]['map']:.3f} ({rows[0]['status']}), S {rows[1]['status']}, exit code {code}; "
        f"{wall:.1f} s [{card}]")
    return dict(launches=len(launches), K=ks, code=code, rows=rows, max_abs_err=err,
                wall_s=wall), weights


def infer_jpeg_phase(root: str, weights: str, card: str) -> dict:
    """Phase 35d: the infer CLI with [35c]'s N file over data/images writes
    each drawn image under its source's name as a JPEG (SOI to EOI, the
    source's size), one keep an image equal to the plain keep."""
    from yolov6_tpu_torch.data.image_io import image_format, imread
    from yolov6_tpu_torch.tools import infer as infer_cli

    out = os.path.join(root, "infer_n_jpeg")
    args = infer_cli.get_args_parser().parse_args([
        "--weights", weights, "--config", os.path.join(ROOT, "configs", "yolov6n.py"),
        "--source", os.path.join(ROOT, "data", "images"), "--save-txt", "--save-dir", out,
        "--device", "cuda"])
    with KeepRecorder(record_all=True) as rec:
        t0 = time.perf_counter()
        infer_cli.run(args)
        wall = time.perf_counter() - t0
    launches, err = rec.check_all("[35] infer CLI JPEG output")
    assert len(launches) == len(DEMO_JPEGS)
    for name, (shape, _) in DEMO_JPEGS.items():
        drawn = os.path.join(out, "images", os.path.basename(name))
        assert image_format(drawn) == "jpeg", f"[35] {drawn} is not a JPEG"
        with open(drawn, "rb") as f:
            data = f.read()
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        assert imread(drawn).shape == shape
    log(f"[35] infer CLI (N, the gate's .pt) over data/images: image1.jpg, image2.jpg, "
        f"image3.jpg written as JPEG at the sources' sizes, {len(launches)} keeps (B=1, K "
        f"{launches[0]['boxes'].shape[1]}) equal to the plain keep; {wall:.1f} s [{card}]")
    return dict(launches=len(launches), max_abs_err=err, wall_s=wall)


# [36b]: [11]'s 64 val images, every other one rewritten as TIFF and the rest as WebP
FORMAT_EVAL = dict(n_val=64, batch=32)
# [36a]: the square image whose TIFF and WebP files time each decoder
CODEC_TIMING = dict(size=640, repeats=5)


def format_codec_phase(card: str) -> dict:
    """Phase 36a: the TIFF, DNG, WebP, MPO, RLE BMP, CMYK/YCCK JPEG and PNG
    ``eXIf`` fixtures (tests/data/torch_images/) decode to the SHA-256 of the
    JAX package's pixels (cv2.imread, or its PIL branch) that
    tests/torch_image_fixtures.py wrote beside them, and the files it
    refuses raise ``ValueError``; the demo JPEGs' pixels encode to the bytes
    of ``cv2.imencode('.tif')`` (their SHA-256) and, through ``encode_webp``,
    to a lossless WebP the port decodes back to them; each decoder's time
    an image on a 640x640 file (host clock, the median of 5)."""
    import hashlib
    import statistics

    import numpy as np

    from yolov6_tpu_torch.data import tiff, webp
    from yolov6_tpu_torch.data.image_io import imread
    from yolov6_tpu_torch.data.tiff import decode_tiff, encode_tiff
    from yolov6_tpu_torch.data.webp import decode_webp, encode_webp

    with open(os.path.join(IMAGE_FIXTURES, "hashes.json")) as f:
        manifest = json.load(f)
    t0 = time.perf_counter()
    tiff.load()
    webp.load()  # both built by the host g++ here, at their first use
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, want in manifest["images"].items():
        img = imread(os.path.join(IMAGE_FIXTURES, name))
        assert list(img.shape) == want["shape"], f"[36] {name}: {img.shape}, {want['shape']}"
        assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"], \
            f"[36] {name}: the decode differs from the JAX package's"
    decode_s = time.perf_counter() - t0
    for name in manifest["refused"]:
        try:
            imread(os.path.join(IMAGE_FIXTURES, name))
        except ValueError:
            continue
        raise AssertionError(f"[36] {name} decoded; the JAX package refuses it")
    encoded = {}
    for rel, want in manifest["encoded_tiff"].items():
        img = imread(os.path.join(ROOT, rel))
        t0 = time.perf_counter()
        data = encode_tiff(img)
        tiff_ms = (time.perf_counter() - t0) * 1e3
        assert len(data) == want["bytes"] and hashlib.sha256(data).hexdigest() == want["sha256"], \
            f"[36] {rel}: encode_tiff's bytes differ from cv2.imencode('.tif')'s"
        t0 = time.perf_counter()
        lossless = encode_webp(img)
        webp_ms = (time.perf_counter() - t0) * 1e3
        assert np.array_equal(decode_webp(lossless), img), f"[36] {rel}: encode_webp is lossy"
        encoded[rel] = dict(tiff_bytes=len(data), tiff_encode_ms=tiff_ms,
                            webp_bytes=len(lossless), webp_encode_ms=webp_ms)
    # a 640x640 image: the second demo JPEG mirrored out to square, as the
    # lossy fixture infer_source.webp holds it
    n = CODEC_TIMING["size"]
    demo = imread(os.path.join(ROOT, "data", "images", "image2.jpg"))
    square = np.ascontiguousarray(np.concatenate([demo, demo[:, ::-1][:, :n - demo.shape[1]]],
                                                 axis=1))
    with open(os.path.join(IMAGE_FIXTURES, "infer_source.webp"), "rb") as f:
        lossy = f.read()
    files = {"tiff_lzw": (decode_tiff, encode_tiff(square)),
             "webp_lossless": (decode_webp, encode_webp(square)),
             "webp_lossy": (decode_webp, lossy)}
    decode_ms = {}
    for kind, (fn, data) in files.items():
        out = fn(data)
        assert out.shape == (n, n, 3), (kind, out.shape)
        if kind != "webp_lossy":
            assert np.array_equal(out, square), kind
        times = []
        for _ in range(CODEC_TIMING["repeats"]):
            t0 = time.perf_counter()
            fn(data)
            times.append((time.perf_counter() - t0) * 1e3)
        decode_ms[kind] = dict(ms=statistics.median(times), bytes=len(data))
    log(f"[36] the TIFF and WebP codecs loaded in {build_s:.2f} s; "
        f"{len(manifest['images'])} fixture files decode to the JAX package's pixels (sha256) in "
        f"{decode_s * 1e3:.1f} ms, {len(manifest['refused'])} refused "
        f"({', '.join(manifest['refused'])}); the demo JPEGs encode to cv2.imencode('.tif')'s "
        "bytes and to lossless WebP read back exactly: "
        + ", ".join(f"{os.path.basename(k)} TIFF {v['tiff_bytes']} B in "
                    f"{v['tiff_encode_ms']:.1f} ms, WebP {v['webp_bytes']} B in "
                    f"{v['webp_encode_ms']:.1f} ms" for k, v in encoded.items())
        + f"; decode of a {n}x{n} image (median of {CODEC_TIMING['repeats']}, host clock): "
        + ", ".join(f"{k} {v['ms']:.2f} ms ({v['bytes']} B)" for k, v in decode_ms.items())
        + f" [{card}]")
    return dict(fixtures=len(manifest["images"]), refused=manifest["refused"], build_s=build_s,
                decode_s=decode_s, encoded=encoded, decode_ms=decode_ms)


def format_eval_phase(data: dict, cfg, root: str, dev, card: str) -> dict:
    """Phase 36b: S (configs/yolov6s.py, seeded weights) through
    ``tools/eval.py::run`` at b32@640 in bf16 over [11]'s 64 PNG images, then
    over the same images rewritten by ``encode_tiff`` (every other one) and
    ``encode_webp`` (the rest), both lossless: the COCO rows equal row for
    row, two keep launches on the rewritten set, the first with a candidate
    equal to the plain keep. cuDNN runs deterministic for the two passes."""
    import glob
    import shutil

    import torch

    from yolov6_tpu_torch.data.image_io import image_format, imread, imwrite
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms
    from yolov6_tpu_torch.tools import eval as eval_cli

    t = FORMAT_EVAL
    pngs = sorted(glob.glob(os.path.join(data["val"], "*.png")))
    assert len(pngs) == t["n_val"]
    img_dir, lb_dir = (os.path.join(root, kind, "val_formats") for kind in ("images", "labels"))
    os.makedirs(img_dir)
    os.makedirs(lb_dir)
    t0 = time.perf_counter()
    kinds = {}
    for i, path in enumerate(pngs):
        stem = os.path.splitext(os.path.basename(path))[0]
        ext = ".tif" if i % 2 == 0 else ".webp"
        out = os.path.join(img_dir, stem + ext)
        img = imread(path)
        imwrite(out, img)
        assert (imread(out) == img).all(), f"[36] {out} does not read back to its PNG's pixels"
        kinds[image_format(out)] = kinds.get(image_format(out), 0) + 1
        shutil.copy(os.path.join(root, "labels", "val", stem + ".txt"), lb_dir)
    write_s = time.perf_counter() - t0
    assert kinds == {"tiff": t["n_val"] // 2, "webp": t["n_val"] // 2}, kinds
    paths = {}
    for name, val in (("png", data["val"]), ("formats", img_dir)):
        paths[name] = os.path.join(root, f"data80_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(dict(data, val=val), f)
    model = deploy_model(cfg, 0, dev)
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        kw = dict(model=model, batch_size=t["batch"], img_size=IMG, task="val", half=True,
                  device="cuda")
        t0 = time.perf_counter()
        (ap50_png, ap_png), rows_png = eval_cli.run(
            data=paths["png"], save_dir=os.path.join(root, "eval_png"), **kw)
        png_s = time.perf_counter() - t0
        greedy_nms.launches = 0  # the PNG pass above is the reference, not the path
        with KeepRecorder() as rec:
            t0 = time.perf_counter()
            (ap50, ap), rows = eval_cli.run(
                data=paths["formats"], save_dir=os.path.join(root, "eval_formats"), **kw)
            wall = time.perf_counter() - t0
        launches = greedy_nms.launches
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    walk = rec.check("[36] eval CLI over TIFF and WebP", t["n_val"])
    assert launches == walk["launches"] == t["n_val"] // t["batch"], launches
    assert len(rows) == len(rows_png) > 0, (len(rows), len(rows_png))
    assert rows == rows_png, "[36] the TIFF/WebP set's COCO rows differ from the PNG set's"
    assert (ap50, ap) == (ap50_png, ap_png)
    del model
    log(f"[36] eval CLI (tools/eval.py::run), S at b{t['batch']}@{IMG} bf16 over [11]'s "
        f"{t['n_val']} images as {kinds['tiff']} TIFF (encode_tiff) + {kinds['webp']} lossless "
        f"WebP (encode_webp), written in {write_s:.1f} s: {len(rows)} COCO rows equal to the PNG "
        f"set's row for row (AP50 {ap50:.5f}, AP {ap:.5f}); {launches} keep launches, the first "
        f"with a candidate (K {walk['first']['eval']['boxes'].shape[1]}, "
        f"{walk['first']['eval']['kept']} kept) equal to the plain keep; the PNG pass "
        f"{png_s:.1f} s, the TIFF/WebP pass {wall:.1f} s [{card}]")
    return dict(launches=launches, rows=len(rows), ap50=ap50, ap=ap, write_s=write_s,
                png_s=png_s, wall_s=wall, max_abs_err=walk["max_abs_err"],
                tiles_visited=walk["tiles_visited"])


def format_infer_phase(root: str, weights: str, card: str) -> dict:
    """Phase 36c: the infer CLI with [35c]'s N file over a TIFF source (LZW,
    ``encode_tiff`` of the first demo JPEG's pixels) and a lossy WebP source
    (tests/data/torch_images/infer_source.webp), each also under a ``.png``
    name: one keep an image, each equal to the plain keep; the drawn TIFF is
    written as ``cv2.imwrite`` writes it (the bytes of ``encode_tiff`` of the
    drawn pixels, which the PNG twin holds) and the drawn WebP reads back to
    the twin's pixels."""
    import shutil

    from yolov6_tpu_torch.data.image_io import image_format, imread
    from yolov6_tpu_torch.data.tiff import encode_tiff
    from yolov6_tpu_torch.tools import infer as infer_cli

    src = os.path.join(root, "formats_src")
    os.makedirs(src)
    with open(os.path.join(src, "scene.tif"), "wb") as f:
        f.write(encode_tiff(imread(os.path.join(ROOT, "data", "images", "image1.jpg"))))
    shutil.copy(os.path.join(IMAGE_FIXTURES, "infer_source.webp"), os.path.join(src, "scene.webp"))
    for name in ("scene.tif", "scene.webp"):  # the same bytes under a PNG's name
        shutil.copy(os.path.join(src, name), os.path.join(src, name.replace(".", "_") + ".png"))
    out = os.path.join(root, "infer_formats")
    args = infer_cli.get_args_parser().parse_args([
        "--weights", weights, "--config", os.path.join(ROOT, "configs", "yolov6n.py"),
        "--source", src, "--save-txt", "--save-dir", out, "--device", "cuda"])
    with KeepRecorder(record_all=True) as rec:
        t0 = time.perf_counter()
        infer_cli.run(args)
        wall = time.perf_counter() - t0
    launches, err = rec.check_all("[36] infer CLI TIFF/WebP output")
    assert len(launches) == 4, len(launches)
    drawn_dir = os.path.join(out, os.path.basename(src))
    for name, fmt in (("scene.tif", "tiff"), ("scene.webp", "webp")):
        mine = os.path.join(drawn_dir, name)
        twin = imread(os.path.join(drawn_dir, name.replace(".", "_") + ".png"))
        assert image_format(mine) == fmt, f"[36] {mine} is not a {fmt} file"
        assert (imread(mine) == twin).all(), f"[36] {mine} differs from the drawn pixels"
        if fmt == "tiff":
            with open(mine, "rb") as f:
                assert f.read() == encode_tiff(twin), f"[36] {mine} is not cv2's TIFF bytes"
    log(f"[36] infer CLI (N, the gate's .pt) over scene.tif (LZW) and scene.webp (lossy) and "
        f"their PNG twins: the drawn images written as TIFF (encode_tiff's bytes of the drawn "
        f"pixels) and lossless WebP (read back exactly), {len(launches)} keeps (B=1, K "
        f"{launches[0]['boxes'].shape[1]}) equal to the plain keep; {wall:.1f} s [{card}]")
    return dict(launches=len(launches), max_abs_err=err, wall_s=wall)


# [37]: the video clip the infer CLI and the ONNX demo run over: [11]'s 64
# val images, each centred on a grey 1280x720 frame, written at 30 fps by the
# port's writer (MPEG-4 Part 2 in MP4, every frame an I-VOP)
VIDEO_CLIP = dict(width=1280, height=720, fps=30, frames=64)
VIDEO_FIXTURES = "tests/data/torch_videos"
# [37b]: the learning gate's N through the infer CLI at 640 (a 1280x720 frame
# letterboxed to 640x360 inside 640x640), conf as [23]'s gate run; every
# eighth frame's keep (and the first with a candidate) held against the plain
# keep; [37c]: the ONNX demo's loop over the clip's first 16 frames (S with
# seeded weights keeps its 300 a frame, which the host draws at about 1 ms a
# box)
VIDEO_INFER = dict(img_size=640, conf_thres=0.25, check_every=8)
VIDEO_ONNX_FRAMES = 16


def video_codec_phase(data: dict, root: str, card: str) -> tuple:
    """Phase 37a: each video of tests/data/torch_videos/ decodes (the port's
    demuxers, MPEG-4 Part 2 decoder and Motion JPEG path, built by this
    machine's g++) to its manifest's frames (sha256), count, fps and size;
    then the port's writer makes the 1280x720 clip of [11]'s images, timed a
    frame, and its decode and a Motion JPEG frame's are timed a frame.
    Returns the phase's numbers and the clip's path."""
    import glob
    import hashlib
    import statistics

    import numpy as np

    from yolov6_tpu_torch.data import jpeg, video
    from yolov6_tpu_torch.data.image_io import imread

    t0 = time.perf_counter()
    with open(os.path.join(ROOT, VIDEO_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name, want in manifest.items():
        cap = video.VideoCapture(os.path.join(ROOT, VIDEO_FIXTURES, name))
        digest, n = hashlib.sha256(), 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            digest.update(frame.tobytes())
            n += 1
        got = (n, digest.hexdigest(), cap.track.codec, cap.get(video.CAP_PROP_FRAME_COUNT),
               cap.get(video.CAP_PROP_FPS), cap.get(video.CAP_PROP_FRAME_WIDTH),
               cap.get(video.CAP_PROP_FRAME_HEIGHT))
        cap.release()
        assert got == (want["frames"], want["sha256"], want["codec"], want["frame_count"],
                       want["fps"], want["width"], want["height"]), f"[37a] {name}: {got}"
    fixtures_s = time.perf_counter() - t0

    w, h, fps, n = (VIDEO_CLIP[k] for k in ("width", "height", "fps", "frames"))
    images = sorted(glob.glob(os.path.join(data["val"], "*.png")))[:n]
    assert len(images) == n
    clip = os.path.join(root, "video", "clip.mp4")
    os.makedirs(os.path.dirname(clip), exist_ok=True)
    writer = video.VideoWriter(clip, fps, (w, h))
    frames, encode_ms = [], []
    for path in images:
        img = imread(path)
        frame = np.full((h, w, 3), 114, np.uint8)
        y0, x0 = (h - img.shape[0]) // 2, (w - img.shape[1]) // 2
        frame[y0:y0 + img.shape[0], x0:x0 + img.shape[1]] = img
        t1 = time.perf_counter()
        writer.write(frame)
        encode_ms.append((time.perf_counter() - t1) * 1e3)
        frames.append(frame)
    writer.release()
    cap = video.VideoCapture(clip)
    decode_ms, psnr = [], []
    while True:
        t1 = time.perf_counter()
        ok, frame = cap.read()
        if not ok:
            break
        decode_ms.append((time.perf_counter() - t1) * 1e3)
        err = np.mean((frame.astype(np.float64) - frames[len(psnr)]) ** 2)
        psnr.append(10 * np.log10(255.0 ** 2 / err) if err else float("inf"))
    got = (len(decode_ms), cap.get(video.CAP_PROP_FPS), cap.get(video.CAP_PROP_FRAME_WIDTH),
           cap.get(video.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    assert got == (n, fps, w, h), f"[37a] the clip read back as {got}"
    assert min(psnr) > 30, f"[37a] the clip's frames read back at PSNR {min(psnr):.2f} dB"
    # a Motion JPEG frame of the clip's size: the JPEG the encoder writes as
    # cv2.imencode does, then the MJPEG path of VideoCapture.read
    data_jpeg = jpeg.encode_jpeg(frames[0], quality=90)
    mjpeg_ms = []
    for _ in range(9):
        t1 = time.perf_counter()
        video.yuv_to_bgr(*jpeg.decode_jpeg_planes(data_jpeg), full_range=True)
        mjpeg_ms.append((time.perf_counter() - t1) * 1e3)
    out = dict(fixtures=len(manifest), fixtures_s=fixtures_s,
               clip_bytes=os.path.getsize(clip), clip_min_psnr=min(psnr),
               encode_ms=statistics.median(encode_ms), decode_ms=statistics.median(decode_ms),
               mjpeg_decode_ms=statistics.median(mjpeg_ms))
    log(f"[37a] {len(manifest)} videos of {VIDEO_FIXTURES} (mp4v in MP4, MOV, AVI and MKV; MJPEG "
        f"in AVI and MKV) decode to the manifest's frames (sha256), count, fps and size in "
        f"{fixtures_s:.2f} s; the port's writer made a {w}x{h} clip of {n} of [11]'s images at "
        f"{fps} fps ({out['clip_bytes']} bytes, I-VOPs at quantiser "
        f"{video.WRITER_QUANT}, read back at PSNR >= {min(psnr):.2f} dB); host ms a {w}x{h} "
        f"frame, median: encode {out['encode_ms']:.2f} (BGR to 4:2:0 and the I-VOP), mp4v "
        f"decode {out['decode_ms']:.2f} (demux, decode, BGR), MJPEG decode "
        f"{out['mjpeg_decode_ms']:.2f} (a {len(data_jpeg)}-byte frame: planes and BGR) [{card}]")
    return out, clip


class VideoStepTimer(StepTimer):
    """Times, while active, the steps of the inferer's per-frame loop over a
    video (host clock): decode (``VideoCapture.read``), letterbox, device
    (the infer function, synchronised), draw (``plot_box_and_label`` and the
    FPS overlay's ``draw_text``), encode (``VideoWriter.write``) and the
    loop (``Inferer.infer``); the rest of the loop is the rescale and the
    label rows."""

    STEPS = ("decode", "letterbox", "device", "draw", "encode", "loop")

    def __enter__(self):
        from yolov6_tpu_torch.data import video

        timed = self._timed
        mod, cls = self.inferer_mod, self.inferer_mod.Inferer
        self.saved = [(video.VideoCapture, "read", video.VideoCapture.read),
                      (video.VideoWriter, "write", video.VideoWriter.write),
                      (mod, "make_infer_fn", mod.make_infer_fn),
                      (cls, "process_image", cls.process_image),
                      (cls, "plot_box_and_label", cls.__dict__["plot_box_and_label"]),
                      (cls, "draw_text", cls.__dict__["draw_text"]),
                      (cls, "infer", cls.infer)]
        make = mod.make_infer_fn
        video.VideoCapture.read = timed("decode", video.VideoCapture.read)
        video.VideoWriter.write = timed("encode", video.VideoWriter.write)
        mod.make_infer_fn = lambda *a, **kw: timed("device", make(*a, **kw), sync=True)
        cls.process_image = timed("letterbox", cls.process_image)
        cls.plot_box_and_label = staticmethod(timed("draw", cls.plot_box_and_label))
        cls.draw_text = staticmethod(timed("draw", cls.draw_text))
        cls.infer = timed("loop", cls.infer)
        return self

    def __exit__(self, *exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)


def video_infer_phase(root: str, clip: str, card: str) -> dict:
    """Phase 37b: the infer CLI (``tools/infer.py::run``) over [37a]'s clip
    with [13]'s gate N: one keep launch a frame (B=1, K 2000), the first keep
    with a candidate and every eighth frame's equal to the plain keep; the
    written .mp4, read back by the port, has the clip's frames, fps and
    size, with a label file beside it; the loop's imgs/s and its steps a
    frame."""
    import glob

    from yolov6_tpu_torch.data import video
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov6_tpu_torch.tools import infer as infer_cli

    import torch

    gate_ckpt = glob.glob(os.path.join(root, "gate", "**", "weights", "last_ckpt.pt"),
                          recursive=True)
    assert len(gate_ckpt) == 1, f"[37b] the gate's checkpoint: {gate_ckpt}"
    out = os.path.join(root, "video", "infer")
    v = VIDEO_INFER
    args = infer_cli.get_args_parser().parse_args([
        "--weights", gate_ckpt[0], "--config", os.path.join(ROOT, "configs", "yolov6n.py"),
        "--source", clip, "--yaml", os.path.join(root, "gate", "dataset", "data.json"),
        "--img-size", str(v["img_size"]), "--conf-thres", str(v["conf_thres"]), "--save-txt",
        "--save-dir", out, "--device", "cuda"])
    greedy_nms.launches = 0
    with KeepRecorder(record_all=True) as rec, VideoStepTimer() as timer:
        infer_cli.run(args)
    launches = greedy_nms.launches
    n = VIDEO_CLIP["frames"]
    assert launches == len(rec.all) == n, f"[37b] {launches} keep launches for {n} frames"
    checked = sorted({i for i in range(0, n, v["check_every"])} | {next(
        (i for i, f in enumerate(rec.all) if bool((f["scores"] > 0).any())), 0)})
    err, with_candidate = 0.0, 0
    for i in checked:
        f = rec.all[i]
        assert f["boxes"].shape == (1, INFER_CLI["max_nms"], 4) and f["emit_once"]
        idx_p, valid_p = greedy_nms_plain(f["boxes"], f["scores"], f["max_det"], f["iou_thres"],
                                          emit_once=True)
        assert torch.equal(f["idx"], idx_p) and torch.equal(f["valid"], valid_p), \
            f"[37b] frame {i}: the kernel's keep differs from the plain keep"
        with_candidate += bool((f["scores"] > 0).any())
        err = max(err, float((f["idx"] - idx_p).abs().max()))
    assert with_candidate, "[37b] no checked keep had a candidate"
    kept = [int(f["valid"].sum()) for f in rec.all]
    written = os.path.join(out, "clip.mp4")
    cap = video.VideoCapture(written)
    frames = 0
    while cap.read()[0]:
        frames += 1
    got = (frames, cap.get(video.CAP_PROP_FPS), cap.get(video.CAP_PROP_FRAME_WIDTH),
           cap.get(video.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    want = (n, VIDEO_CLIP["fps"], VIDEO_CLIP["width"], VIDEO_CLIP["height"])
    assert got == want, f"[37b] the written video read back as {got}, not {want}"
    with open(os.path.join(out, "labels", "clip.txt")) as fh:
        rows = fh.read().splitlines()
    assert len(rows) == sum(kept) and all(len(r.split()) == 6 for r in rows)
    steps = {k: s * 1e3 / n for k, s in timer.s.items()}
    steps["rest"] = steps["loop"] - sum(steps[k] for k in steps if k != "loop")
    res = dict(launches=launches, checked=len(checked), checked_with_candidate=with_candidate,
               max_abs_err=err, kept=sum(kept), rows=len(rows), frames=frames,
               imgs_per_s=n / timer.s["loop"], steps_ms=steps)
    log(f"[37b] infer CLI over the {VIDEO_CLIP['width']}x{VIDEO_CLIP['height']} clip ({n} "
        f"frames at {VIDEO_CLIP['fps']} fps) with [13]'s gate N at {v['img_size']}, conf "
        f"{v['conf_thres']}: {launches} kernel launches (B=1, K {INFER_CLI['max_nms']} each), "
        f"{len(checked)} keeps checked ({with_candidate} with a candidate) equal to the plain "
        f"emit-once keep; {sum(kept)} detections, as many label rows; the written .mp4 reads "
        f"back as {frames} frames at {got[1]:g} fps, {int(got[2])}x{int(got[3])}; "
        f"{res['imgs_per_s']:.2f} imgs/s; ms a frame: "
        + ", ".join(f"{k} {s:.2f}" for k, s in steps.items()) + f" (host clock) [{card}]")
    return res


def video_onnx_phase(root: str, clip: str, onnx_path: str, card: str) -> dict:
    """Phase 37c: ``tools/onnx_demo.py`` over [37a]'s clip with [33c]'s ONNX
    file (its first 16 frames): one keep launch a frame, each frame's keep
    (the demo's multi-label keep at B=1, max_det 300) equal to the plain
    keep, the frame and detection counts printed, the written .mp4 read back
    at the clip's fps and size."""
    import contextlib
    import io

    import torch

    from yolov6_tpu_torch.data import video
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov6_tpu_torch.tools import onnx_demo

    out = os.path.join(root, "video", "onnx_demo.mp4")
    args = onnx_demo.get_args_parser().parse_args([
        "--model", onnx_path, "--source", clip, "--save", out, "--max-frames",
        str(VIDEO_ONNX_FRAMES), "--device", "cuda"])
    greedy_nms.launches = 0
    printed = io.StringIO()
    t0 = time.perf_counter()
    with KeepRecorder(record_all=True) as rec, contextlib.redirect_stdout(printed):
        frames, dets = onnx_demo.main(args)
    wall = time.perf_counter() - t0
    launches = greedy_nms.launches
    last = printed.getvalue().splitlines()[-1]
    assert last == f"{frames} frames, {dets} detections" and frames == VIDEO_ONNX_FRAMES, last
    assert launches == len(rec.all) == frames, f"[37c] {launches} keep launches for {frames} frames"
    # every frame's keep against the plain keep: the printed count alone would
    # not show a wrong keep, since each frame may fill max_det
    err, with_candidate = 0.0, 0
    for i, f in enumerate(rec.all):
        assert f["boxes"].shape[0] == 1, f"[37c] frame {i}: keep of {f['boxes'].shape[0]} images"
        idx_p, valid_p = greedy_nms_plain(f["boxes"], f["scores"], f["max_det"], f["iou_thres"],
                                          emit_once=f["emit_once"])
        assert torch.equal(f["idx"], idx_p) and torch.equal(f["valid"], valid_p), \
            f"[37c] frame {i}: the kernel's keep differs from the plain keep"
        with_candidate += bool((f["scores"] > 0).any())
        err = max(err, float((f["idx"] - idx_p).abs().max()))
    assert with_candidate, "[37c] no keep had a candidate"
    kept = sum(int(f["valid"].sum()) for f in rec.all)
    assert kept == dets, f"[37c] {kept} boxes kept, {dets} detections printed"
    cap = video.VideoCapture(out)
    got = (cap.get(video.CAP_PROP_FRAME_COUNT), cap.get(video.CAP_PROP_FPS),
           cap.get(video.CAP_PROP_FRAME_WIDTH), cap.get(video.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    assert got == (frames, VIDEO_CLIP["fps"], VIDEO_CLIP["width"], VIDEO_CLIP["height"]), got
    log(f"[37c] ONNX demo (tools/onnx_demo.py, [33c]'s S file through OnnxTorchModule) over the "
        f"clip's first {frames} frames: printed '{last}'; {launches} kernel launches (B=1, K "
        f"{sorted({f['boxes'].shape[1] for f in rec.all})}, max_det {rec.all[0]['max_det']}), "
        f"each equal to the plain keep ({with_candidate} with a candidate, {kept} kept); the "
        f"written .mp4 reads back at {got[1]:g} fps, {int(got[2])}x{int(got[3])}; "
        f"{frames / wall:.2f} imgs/s with the draw, the writer and the checks' recording "
        f"(host clock) [{card}]")
    return dict(launches=launches, frames=frames, detections=dets, wall_s=wall,
                checked=len(rec.all), checked_with_candidate=with_candidate, max_abs_err=err)


DRAW_FIXTURES = "tests/data/torch_draw/hashes.json"
# [38]'s timed draws: an image the size of the demo JPEGs' largest with 1000
# seeded detections (the infer CLI's max_det), and one label a call
DRAW_TIMING = dict(height=810, width=1080, detections=1000, repeats=3, label_calls=2000)


def draw_case(case):
    """One case of ``DRAW_FIXTURES`` drawn by the port (``utils/draw.py``)
    on the synthetic generator's background: the port's side of
    ``tests/torch_draw_fixtures.py::draw_case_cv2``."""
    import numpy as np

    from yolov6_tpu_torch.data.synth_detect import _background
    from yolov6_tpu_torch.utils import draw, text

    h, w = case["size"]
    img = _background(np.random.default_rng(case["seed"]), h, w)
    for name, *a in case["calls"]:
        if name == "plot_box_and_label":
            lw, box, label, color = a
            draw.plot_box_and_label(img, lw, box, label, color=tuple(color))
        elif name == "put_text":
            s, org, face, scale, color, th = a
            text.put_text(img, s, tuple(org), face, scale, tuple(color), th, text.LINE_AA)
        elif name == "rectangle":
            p1, p2, color, th, line_type = a
            draw.rectangle(img, tuple(p1), tuple(p2), tuple(color), th, line_type)
        elif name == "circle":
            c, r, color, th = a
            draw.circle(img, tuple(c), r, tuple(color), th)
        elif name == "fill_poly":
            pts, color = a
            draw.fill_poly(img, [np.array(q) for q in pts], tuple(color))
        elif name == "draw_text":
            s, pos, scale, th, fg, bg = a
            draw.draw_text(img, s, pos=tuple(pos), font_scale=scale, font_thickness=th,
                           text_color=tuple(fg), text_color_bg=tuple(bg))
        else:
            raise ValueError(f"[38] unknown call {name}")
    return img


def build_drawing() -> dict:
    """Build ``utils/csrc/truetype.cc`` and ``drawing.cc`` with the host g++
    (their first use in this run, before the gates' children draw their
    synthetic sets) and time each; ``built`` is false where ``build/host/``
    already held the library."""
    from yolov6_tpu_torch.data.native_aug import library_path
    from yolov6_tpu_torch.utils import draw, text

    out = {}
    for mod in (text, draw):
        built = not os.path.exists(library_path(mod.SOURCE))
        t0 = time.perf_counter()
        mod.load()
        out[os.path.basename(mod.SOURCE)] = dict(s=time.perf_counter() - t0, built=built)
    return out


def draw_phase(root: str, card: str, build_s: dict) -> dict:
    """Phase 38: cv2 5.0's drawing on the card machine's host, which has no
    cv2: ``build_drawing``'s g++ times printed; every case of ``DRAW_FIXTURES`` (text, boxes, labels, shapes, the
    FPS overlay) and the synthetic generator's first images equal to the
    SHA-256 of what the JAX package's cv2 calls draw; ``put_text`` of a
    label and ``plot_box_and_label`` over an image of 1000 detections timed
    on the host clock."""
    import hashlib
    import statistics

    import numpy as np

    from yolov6_tpu_torch.data.image_io import imread
    from yolov6_tpu_torch.data.synth_detect import generate_split
    from yolov6_tpu_torch.utils import draw, text

    log("[38] g++ -O3 builds at their first use, before [13] and [17] start (host clock): "
        + ", ".join(f"{name} {b['s']:.2f} s" if b["built"] else f"{name} found built"
                    for name, b in build_s.items()))

    with open(os.path.join(ROOT, DRAW_FIXTURES)) as f:
        fixtures = json.load(f)
    def digest(img):
        return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()

    for case in fixtures["cases"]:
        assert digest(draw_case(case)) == case["sha256"], \
            f"[38] {case['name']}: the port's drawing differs from cv2 {fixtures['opencv']}'s"
    synth = fixtures["synth"]
    split = os.path.join(root, "draw_synth")
    generate_split(os.path.join(split, "images"), os.path.join(split, "labels"), synth["n"],
                   synth["img_size"], synth["nc"], np.random.default_rng(synth["seed"]),
                   "train")
    for i, want in enumerate(synth["sha256"]):
        got = digest(imread(os.path.join(split, "images", f"train{i:05d}.png")))
        assert got == want, f"[38] synthetic image {i} differs from the JAX generator's"

    t = DRAW_TIMING
    rng = np.random.default_rng(38)
    img0 = np.full((t["height"], t["width"], 3), 114, np.uint8)
    lw = max(round(sum(img0.shape) / 2 * 0.003), 2)
    a, b = (rng.uniform(0, 1, (t["detections"], 2)) * [t["width"], t["height"]]
            for _ in range(2))
    boxes = np.concatenate([np.minimum(a, b), np.maximum(a, b)], 1)
    labels = [f"class{int(c)} {s:.2f}" for c, s in zip(rng.integers(0, 80, len(boxes)),
                                                       rng.uniform(0.25, 1.0, len(boxes)))]
    colors = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in labels]
    plot_ms = []
    for _ in range(t["repeats"]):
        img = img0.copy()
        t0 = time.perf_counter()
        for box, label, color in zip(boxes, labels, colors):
            draw.plot_box_and_label(img, lw, box, label, color=color)
        plot_ms.append((time.perf_counter() - t0) * 1e3)
    img = img0.copy()
    t0 = time.perf_counter()
    for i in range(t["label_calls"]):
        text.put_text(img, labels[i % len(labels)], (20, 60), text.FONT_HERSHEY_COMPLEX,
                      lw / 3, (255, 255, 255), max(lw - 1, 1), text.LINE_AA)
    label_us = (time.perf_counter() - t0) * 1e6 / t["label_calls"]
    res = dict(build_s=build_s, cases=len(fixtures["cases"]), synth_images=len(synth["sha256"]),
               plot_box_and_label_ms=statistics.median(plot_ms), plot_runs_ms=plot_ms,
               put_text_label_us=label_us, lw=lw, detections=t["detections"],
               image=[t["height"], t["width"]])
    log(f"[38] the port's drawing equals cv2 {fixtures['opencv']}'s (the JAX package's calls) "
        f"in all {res['cases']} cases of {DRAW_FIXTURES} and the synthetic generator's first "
        f"{res['synth_images']} images (SHA-256)")
    log(f"[38] plot_box_and_label over a {t['width']}x{t['height']} image of "
        f"{t['detections']} detections at lw {lw}: {res['plot_box_and_label_ms']:.1f} ms "
        f"(median of {t['repeats']}: " + ", ".join(f"{v:.1f}" for v in plot_ms)
        + f"); put_text of a label {label_us:.1f} us a call (host clock) [{card}]")
    return res


# [39]: the train path's JPEG read. The committed set and its manifest
# (tests/torch_jpeg_train_fixtures.py), the read timed on two camera-sized
# files written here, and one mosaic epoch of the train CLI over [11]'s
# images rewritten as 1920x1080 JPEGs
JPEG_TRAIN_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_jpeg_train")
JPEG_READ_SIZES = ((1920, 1080), (4032, 3024))  # (w, h): DCT scale 1/2 and 1/4 at 640
JPEG_READ_REPEATS = 5
JPEG_CLI = dict(size=(1920, 1080), workers=8)


def jpeg_read_phase(root: str, card: str) -> dict:
    """Phase 39a-b: every file of ``JPEG_TRAIN_FIXTURES`` through
    ``TrainValDataset.load_image_rgb`` at ``img_size`` 64 and at the
    specific shape 96x160 gives the SHA-256 its manifest holds (the JAX
    native library's read; cv2's oriented reduced read and the native
    bilinear for the Exif-6 file), and through ``imread`` cv2.imread's
    (block-smoothed for the cut progressive files); then the train-path
    read of a 1920x1080 and a 4032x3024 JPEG at 640 timed beside ``imread``
    and ``resize_linear`` of the same file (host clock, one thread)."""
    import hashlib
    import shutil
    import statistics

    import numpy as np

    from yolov6_tpu_torch.data import jpeg
    from yolov6_tpu_torch.data.data_augment import resize_linear
    from yolov6_tpu_torch.data.datasets import TrainValDataset
    from yolov6_tpu_torch.data.image_io import imread

    def digest(img):
        return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()

    with open(os.path.join(JPEG_TRAIN_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    images = os.path.join(root, "jpeg_train_fixtures", "images", "train")
    shutil.copytree(JPEG_TRAIN_FIXTURES, images, ignore=shutil.ignore_patterns("*.json"))
    spec_h, spec_w = manifest["specific_shape"]
    t0 = time.perf_counter()
    reads = 0
    for k, kw in enumerate(({}, dict(specific_shape=True, height=spec_h, width=spec_w))):
        ds = TrainValDataset(images, img_size=manifest["img_size"], augment=True,
                             hyp=dict(mosaic=1.0), **kw)
        for i, path in enumerate(ds.img_paths):
            name = os.path.basename(path)
            want = manifest["files"][name]["reads"][k]
            img = ds.load_image_rgb(i)[0]
            assert list(img.shape[:2]) == want["dst"] and digest(img) == want["sha256"], \
                f"[39a] {name} at {want['target']}: the train-path read differs from {want['from']}"
            reads += 1
    for name, entry in manifest["files"].items():
        assert digest(imread(os.path.join(images, name))) == entry["imread_sha256"], \
            f"[39a] {name}: imread differs from cv2.imread"
    check_s = time.perf_counter() - t0
    denoms = sorted({r["denom"] for e in manifest["files"].values() for r in e["reads"]})
    log(f"[39a] {len(manifest['files'])} fixture files, {reads} train-path reads (DCT scale "
        f"1/{', 1/'.join(map(str, denoms))}; 4:2:0 4:2:2 4:4:4 4:4:0 4:1:1, grey, progressive, "
        f"restarts, odd sizes, two progressive files cut before their last scans, the CMYK and "
        f"PNG fallbacks, Exif 6) equal the manifest's SHA-256 and imread equals cv2.imread on "
        f"every file, in {check_s:.2f} s [{card}]")

    src = imread(os.path.join(ROOT, "data", "images", "image1.jpg"))
    timed = {}
    for w, h in JPEG_READ_SIZES:
        path = os.path.join(root, f"read_{w}x{h}.jpg")
        with open(path, "wb") as f:
            f.write(jpeg.encode_jpeg(resize_linear(src, (w, h))))
        ratio = IMG / max(h, w)
        dst_h, dst_w = int(h * ratio), int(w * ratio)
        denom = jpeg.train_denom(h, w, IMG)
        read_ms, plain_ms = [], []
        for _ in range(JPEG_READ_REPEATS):
            t0 = time.perf_counter()
            img = jpeg.read_jpeg_train(path, denom, dst_h, dst_w)
            read_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            full = resize_linear(imread(path)[:, :, ::-1], (dst_w, dst_h))
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        assert img.shape == full.shape == (dst_h, dst_w, 3)
        diff = float(np.abs(img.astype(np.int16) - full.astype(np.int16)).mean())
        timed[f"{w}x{h}"] = dict(denom=denom, dst=[dst_h, dst_w], bytes=os.path.getsize(path),
                                 read_ms=statistics.median(read_ms),
                                 imread_resize_ms=statistics.median(plain_ms),
                                 read_runs_ms=read_ms, imread_resize_runs_ms=plain_ms,
                                 mean_abs_diff=diff)
        log(f"[39b] train-path read of a {w}x{h} JPEG ({os.path.getsize(path)} B) to "
            f"{dst_w}x{dst_h}: DCT scale 1/{denom} and the native bilinear "
            f"{timed[f'{w}x{h}']['read_ms']:.2f} ms; imread and resize_linear "
            f"{timed[f'{w}x{h}']['imread_resize_ms']:.2f} ms (medians of {JPEG_READ_REPEATS}, "
            f"host clock, one thread); the two images {diff:.2f} levels apart on average [{card}]")
    return dict(fixtures=len(manifest["files"]), reads=reads, check_s=check_s, timed=timed)


def jpeg_train_cli_phase(data: dict, root: str, png_epoch: dict, card: str) -> dict:
    """Phase 39c: [11]'s 64 images written as 1920x1080 JPEGs (stretched,
    their labels as they are; ``encode_jpeg``, eight threads), then one
    mosaic epoch of S b32@640 bf16 through ``tools/train.py::main`` over
    them (DCT scale 1/2 and the native bilinear on every read), its
    in-training eval on [11]'s PNGs through the kernel; its imgs/s and
    loader wait a step beside [12]'s PNG mosaic epoch."""
    import glob
    import shutil
    from multiprocessing.pool import ThreadPool

    from yolov6_tpu_torch.data.data_augment import resize_linear
    from yolov6_tpu_torch.data.image_io import imread
    from yolov6_tpu_torch.data.jpeg import encode_jpeg

    w, h = JPEG_CLI["size"]
    out = os.path.join(root, "jpeg_cli", "images", "train")
    labels = os.path.join(root, "jpeg_cli", "labels", "train")
    os.makedirs(out)
    shutil.copytree(os.path.join(os.path.dirname(os.path.dirname(data["val"])), "labels",
                                 os.path.basename(data["val"])), labels)
    pngs = sorted(glob.glob(os.path.join(data["val"], "*.png")))

    def write(png):
        name = os.path.splitext(os.path.basename(png))[0] + ".jpg"
        with open(os.path.join(out, name), "wb") as f:
            f.write(encode_jpeg(resize_linear(imread(png), (w, h))))

    t0 = time.perf_counter()
    with ThreadPool(JPEG_CLI["workers"]) as pool:
        pool.map(write, pngs)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(f) for f in glob.glob(os.path.join(out, "*.jpg")))
    log(f"[39c] wrote [11]'s {len(pngs)} images as {w}x{h} JPEGs ({nbytes} B) in {write_s:.2f} s "
        f"({JPEG_CLI['workers']} threads) [{card}]")
    path = os.path.join(root, "jpeg_cli", "data80.json")
    with open(path, "w") as f:
        json.dump(dict(data, train=out), f)
    conf = cli_config(root, os.path.join(ROOT, "configs", "yolov6s.py"), "yolov6s_jpeg_cli.py")
    trainer, walk, wall = cli_train(path, conf, root, "s_jpeg", 1, "[39c]", card, "S JPEG",
                                    "--stop_aug_last_n_epoch", "0")
    e = trainer.epoch_stats[0]
    assert e["steps"] == len(pngs) // BATCH, e
    wait_ms = e["loader_wait_s"] / e["steps"] * 1e3
    png_wait_ms = png_epoch["loader_wait_s"] / png_epoch["steps"] * 1e3
    log(f"[39c] the JPEG mosaic epoch: {e['steps']} steps, {e['imgs_per_s']:.1f} imgs/s with the "
        f"loader, loader wait {wait_ms:.2f} ms a step; [12]'s PNG mosaic epoch "
        f"({png_epoch['steps']} steps of 320x240-768x576 PNGs): {png_epoch['imgs_per_s']:.1f} "
        f"imgs/s, loader wait {png_wait_ms:.2f} ms a step (host clock) [{card}]")
    return dict(launches=walk["launches"], images=len(pngs), size=[w, h], write_s=write_s,
                bytes=nbytes, epoch=e, loader_wait_ms=wait_ms, png_epoch_imgs_per_s=png_epoch[
                    "imgs_per_s"], png_loader_wait_ms=png_wait_ms, wall_s=wall,
                max_abs_err=walk["max_abs_err"])


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
    from yolov6_tpu_torch.ops.cuda.nms_kernel import (
        TILE, greedy_nms, greedy_nms_op, greedy_nms_plain,
    )
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
                # sorted: the op as non_max_suppression calls it; unsorted: the
                # wrapper's stable sort, the walk, and idx mapped back
                idx_k, valid_k = (greedy_nms_op(boxes, scores, md, iou, emit_once)
                                  if order == "sorted" else
                                  greedy_nms(boxes, scores, md, iou, emit_once=emit_once))
                idx_p, valid_p = greedy_nms_plain(boxes, scores, md, iou, emit_once=emit_once)
                torch.cuda.synchronize()
                what = f"{name}, {order}, emit_once={emit_once}"
                assert torch.equal(valid_k, valid_p), f"{what}: valid differs from the plain keep"
                assert torch.equal(idx_k, idx_p), f"{what}: idx differs from the plain keep"
                n_valid = int(valid_k.sum())
                assert n_valid > B * md // 2, f"{what}: only {n_valid} kept, the chain is too short"
        # times on the sorted candidates under the default rule, the main path's
        boxes, scores = inputs["sorted"]
        keep = partial(greedy_nms_op, emit_once=True)
        idx_k, valid_k = keep(boxes, scores, md, iou)
        torch.cuda.synchronize()
        tiles = float(greedy_nms.last_tiles.float().mean())
        ms = cuda_ms(lambda: keep(boxes, scores, md, iou), iters=20, queue_ahead=True)
        # one row: the scores pass, then the first tile with a single resolve step
        one_row_ms = cuda_ms(lambda: keep(boxes, scores, 1, iou), iters=20, queue_ahead=True)
        call_ms = cuda_ms(lambda: keep(boxes, scores, md, iou), iters=20)
        unsorted_ms = cuda_ms(lambda: greedy_nms(*unsorted, md, iou), iters=20, queue_ahead=True)
        plain_ms = cuda_ms(lambda: greedy_nms_plain(boxes, scores, md, iou), iters=3, warmup=1)
        b_ms, b_by = bound_ms(*keep_work_sorted(boxes, scores, idx_k, valid_k, TILE))
        any_ms, any_by = bound_ms(*keep_work(boxes, scores, idx_k, valid_k, iou))
        keep_rows[name] = dict(ms=ms, one_row_ms=one_row_ms, call_ms=call_ms,
                               unsorted_ms=unsorted_ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by, any_order_bound_ms=any_ms,
                               any_order_bound_by=any_by, tiles_visited=tiles)
        log(f"[2] greedy_nms {name} B={B} K={K} max_det={md} iou={iou}: equal to plain on "
            f"sorted and unsorted candidates under both rules, {int(valid_k.sum())} kept; "
            f"sorted (tile walk, {tiles:.2f} tiles/image): kernel {ms:.4f} ms (with max_det 1 "
            f"{one_row_ms:.4f} ms), per call {call_ms:.4f} ms; unsorted (sort, walk, map back) {unsorted_ms:.4f} ms; plain "
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
    model_info = model_info_phase(card)

    # ---- 11.-13. COCO evaluation of S and M (and S on rect batches) on a PNG
    # set, the train CLI on a train split beside it, the learning gate
    phase_mark("[11]")
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as root, killing_children():
        # phases 13 and 17, the two gates, in children: [13] runs beside
        # [11]-[31] and is joined before [23]; [17] runs on until it is joined
        # after [37]. Every phase timed meanwhile (the evals, the recipes'
        # steps [14]-[16], the P6 ... RepOpt phases) shares the card and the
        # host with them, and its line says so; none has the card alone
        drawing_build = build_drawing()  # [38] prints its times
        gate_child_ = start_child("[13]", "--learning-gate", root)
        distill_child = start_child("[17]", "--distill-gate", root)
        data = write_eval_set(root, card)
        perfect_mock_phase(data, dev, card)
        model = deploy_model(cfgs["s"], 0, dev)
        eval_s = eval_phase(model, "YOLOv6-S", data, dev, card)
        eval_plots = eval_plots_phase(model, data, root, dev, card)
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
        vis = vis_dataset_phase(train_data, root, card)

        # ---- 14.-16. the training recipes' steps
        phase_mark("[14]")
        recipes = recipe_phases(cfgs, images, dev, card)

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

        # ---- 23. inference: the demo JPEGs, the infer CLI on S, the gate's N
        # (which needs [13]'s checkpoint: its child is joined first, after
        # [24]-[31], which need nothing of it, so that the main process
        # seldom waits for the gate)
        phase_mark("[23]")
        gate = join_child(gate_child_)
        gate_launches = gate["launches"]
        greedy_nms.launches = 0
        infer = infer_phase(root, dev, card)
        infer_launches = greedy_nms.launches

        # ---- 32. INT8 quantisation: PTQ and the quantised serve of [30]'s S, the QAT
        # step, RepOpt's third stage through the train CLI, the PTQ CLI on [13]'s N
        phase_mark("[32]")
        ptq_serve, amax = ptq_serve_phase(repopt_kept, images, dev, card)
        qat_step = qat_step_phase(repopt_kept, amax, dev, card)
        ptq = ptq_model(repopt_kept, amax, dev)  # for [33c]
        del repopt_kept, amax
        greedy_nms.launches = 0
        qat_cli = qat_cli_phase(root, repopt_cli, dev, card)
        qat_cli_launches = greedy_nms.launches
        ptq_cli = ptq_cli_phase(root, dev, card)

        # ---- 33. export and serving: S's .pt2 artifact in a fresh process, its
        # eval, ONNX (and [32]'s PTQ S as QDQ), TorchScript, Lite-S's NCNN files
        phase_mark("[33]")
        model = deploy_model(cfgs["s"], 0, dev)
        export = dict(artifact=artifact_phase(model, images_np, images, root, dev, card))
        export["eval"] = artifact_eval_phase(model, train_data, root, dev, card)
        onnx_path = os.path.join(root, "s.onnx")
        export["onnx"] = onnx_phase(model, images, ptq, onnx_path, dev, card)
        del ptq
        export["torchscript_ncnn"] = torchscript_ncnn_phase(model, images, root, dev, card)
        del model
        # ---- 34. data parallel: the step across two gloo ranks on the card, the
        # train CLI across them, the step in an NCCL group of one
        phase_mark("[34]")
        ddp = ddp_phases(root, dev, card)
        # ---- 35. the image codecs; the train CLI at a specific shape with the
        # checks; the COCO repro gate through both protocols; JPEG infer output
        phase_mark("[35]")
        codecs = image_codec_phase(card)
        greedy_nms.launches = 0
        shape_cli = shape_cli_phase(root, card)
        shape_cli_launches = greedy_nms.launches
        greedy_nms.launches = 0
        gate_repro, gate_n_pt = repro_gate_phase(data, root, dev, card)
        repro_launches = greedy_nms.launches
        greedy_nms.launches = 0
        infer_jpeg = infer_jpeg_phase(root, gate_n_pt, card)
        infer_jpeg_launches = greedy_nms.launches
        # ---- 36. TIFF, WebP and the other formats: the fixtures and codecs;
        # the eval CLI over TIFF and WebP; the infer CLI writing TIFF and WebP
        phase_mark("[36]")
        formats = dict(codecs=format_codec_phase(card))
        greedy_nms.launches = 0
        formats["eval"] = format_eval_phase(data, cfgs["s"], root, dev, card)
        format_eval_launches = greedy_nms.launches
        greedy_nms.launches = 0
        formats["infer"] = format_infer_phase(root, gate_n_pt, card)
        format_infer_launches = greedy_nms.launches
        # ---- 37. video: the fixtures and the codecs' times; the infer CLI
        # over a 1280x720 clip; the ONNX demo's video loop over it
        phase_mark("[37]")
        videos, clip = video_codec_phase(data, root, card)
        videos["infer"] = video_infer_phase(root, clip, card)
        videos["onnx"] = video_onnx_phase(root, clip, onnx_path, card)
        # ---- 38. cv2 5.0's drawing: the text and shapes against cv2's hashes,
        # the synthetic images against the JAX generator's, the draw timed
        phase_mark("[38]")
        drawing = draw_phase(root, card, drawing_build)
        # ---- 39. the train path's JPEG read: the fixtures' hashes, the read
        # timed, one mosaic epoch of the train CLI over 1920x1080 JPEGs
        phase_mark("[39]")
        train_jpeg = jpeg_read_phase(root, card)
        greedy_nms.launches = 0
        train_jpeg["cli"] = jpeg_train_cli_phase(data, root, train_cli["epochs"][0], card)
        jpeg_cli_launches = greedy_nms.launches
        distill_gate = join_child(distill_child)
        phase_mark("end")
    assert train_cli_launches >= train_cli["launches"]
    assert gate["counted_launches"] == gate_launches, gate
    assert distill_gate["counted_launches"] == distill_gate["launches"], distill_gate
    assert all(recipes[k]["launches"] == 0 for k in ("train_fuse_ab", "train_distill_ns",
                                                     "train_m_kd"))
    assert p6_train["train_s6"]["launches"] == p6_train["train_l6"]["launches"] == 0
    assert mbla["train_s"]["launches"] == 0 and p6_cli_launches == p6_cli["launches"]
    assert infer_launches == infer["launches"] + infer["gate_launches"]
    assert repopt_cli_launches == repopt_cli["launches"]
    assert ddp["step"]["launches"] == ddp["nccl"]["launches"] == 0
    assert pan["train_t"]["launches"] == repopt["launches"] == qat_step["launches"] == 0
    assert qat_cli_launches == qat_cli["launches"]
    assert shape_cli_launches == shape_cli["launches"] > 0
    assert repro_launches == gate_repro["launches"] == 2
    assert infer_jpeg_launches == infer_jpeg["launches"] == len(DEMO_JPEGS)
    assert format_eval_launches == formats["eval"]["launches"] == 2
    assert format_infer_launches == formats["infer"]["launches"] == 4
    assert jpeg_cli_launches == train_jpeg["cli"]["launches"] == 2
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
                             "serve_perclass": main["perclass_launches"],
                             "serve_m_perclass": m_serve["perclass_launches"],
                             "eval_s_plots": eval_plots["launches"],
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
                             "quantize_cli_eval_gate_n": ptq_cli["launches"],
                             **{name: export["artifact"][name]["launches"]
                                for name in ("export_s_pt2", "export_s_pt2_fp32")},
                             "eval_artifact_s": export["eval"]["launches"],
                             "train_ddp_step_ranks": ddp["step"]["launches"],
                             "train_cli_ddp_eval_rank0": ddp["cli"]["launches_rank0"],
                             "train_cli_ddp_eval_rank1": ddp["cli"]["launches_rank1"],
                             "eval_ddp_one_process": ddp["cli"]["evaler_launches"],
                             "train_nccl_step": ddp["nccl"]["launches"],
                             "train_cli_specific_shape_eval": shape_cli_launches,
                             "repro_gate_k8192_and_k30000": repro_launches,
                             "infer_jpeg_out": infer_jpeg_launches,
                             "eval_cli_tiff_webp": format_eval_launches,
                             "infer_cli_tiff_webp_out": format_infer_launches,
                             "infer_cli_video": videos["infer"]["launches"],
                             "onnx_demo_video": videos["onnx"]["launches"],
                             "train_cli_jpeg_eval": jpeg_cli_launches},
        "matches_plain": True,
        "max_abs_err": max(main["max_abs_err"], m_serve["max_abs_err"],
                           *(e["kernel"]["max_abs_err"] for e in (eval_s, eval_m, eval_s_rect)),
                           train_cli["max_abs_err"], gate["max_abs_err"],
                           eval_plots["max_abs_err"],
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
                           qat_cli["max_abs_err"], ptq_cli["max_abs_err"],
                           *(v["max_abs_err"] for v in export["artifact"].values()),
                           export["eval"]["max_abs_err"], ddp["cli"]["max_abs_err"],
                           shape_cli["max_abs_err"], gate_repro["max_abs_err"],
                           infer_jpeg["max_abs_err"], formats["eval"]["max_abs_err"],
                           formats["infer"]["max_abs_err"], videos["infer"]["max_abs_err"],
                           videos["onnx"]["max_abs_err"], train_jpeg["cli"]["max_abs_err"]),
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
        "export": export,
        "data_parallel": ddp,
        "image_codecs": codecs,
        "train_cli_specific_shape": shape_cli,
        "repro_gate": gate_repro,
        "infer_jpeg": infer_jpeg,
        "image_formats": formats,
        "video": videos,
        "eval_plots": eval_plots,
        "model_info": model_info,
        "vis_dataset": vis,
        "drawing": drawing,
        "train_jpeg": train_jpeg,
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
    if sys.argv[1:2] == ["--learning-gate"]:
        sys.exit(gate_child(sys.argv[2:], learning_gate_phase))
    if sys.argv[1:2] == ["--distill-gate"]:
        sys.exit(gate_child(sys.argv[2:], distill_gate_phase))
    if sys.argv[1:2] == ["--ddp-step"]:
        sys.exit(ddp_step_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--ddp-cli"]:
        sys.exit(ddp_cli_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--ddp-nccl"]:
        sys.exit(ddp_nccl_child(sys.argv[2:]))
    sys.exit(main())
