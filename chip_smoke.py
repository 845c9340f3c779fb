#!/usr/bin/env python3
"""Drive the PyTorch port (yolov6_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root, one CUDA device

Phases, each of which asserts:
  1. the card, the versions, and the build of every CUDA kernel from csrc/;
  2. each kernel against its plain torch version on the card, at the NMS
     shapes of the serving and eval paths (equal outputs required), timed;
  3. the serving path at full width: YOLOv6-S (configs/yolov6s.py, 80
     classes, deploy) serving 32 uint8 images of 640x640 in fp32 through
     ``make_end2end_fn``; the NMS kernel must be launched and find detections,
     the plain keep must agree on the same predictions, and the CPU decode of
     two of the images must agree with the CUDA decode;
  4. times of the bf16 serving function, with CUDA events.
Then it prints one JSON line of kernels, the nvidia-smi line of the card and,
last, ``{"ok": true, "device": {...}}``. It exits non-zero on any failure,
and when there is no CUDA device.

The weights are random, from seeds: torch's default init, then every conv
re-drawn He-normal so activations stay O(1) through the full depth, and the
head's class and box predictions (zero weights at init, which would give
every anchor the same score) spread as in the CPU tests.
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
]
# CPU vs CUDA fp32 decode (TF32 off): the two sum the convolutions in other
# orders through ~40 layers
DECODE_BOX_TOL = dict(rtol=1e-4, atol=1e-2)  # pixels
DECODE_SCORE_TOL = dict(rtol=0.0, atol=1e-4)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def keep_work(boxes, scores, idx, valid, iou_thres):
    """(bytes, operations) the greedy keep needs for these inputs: each input
    read once and each output written once; per step run, one compare per
    candidate for the argmax and 17 operations of IoU and test per candidate
    still alive. A step runs for each valid row, plus one that finds nothing
    alive when the loop ends early."""
    import torch

    B, K = scores.shape
    md = idx.shape[1]
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + idx.numel() * 4 + valid.numel()
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
            else:
                new = torch.rand(p.shape, generator=gen) * 0.2 - 0.1
            p.copy_(new.to(p.device))


def profile_serve(fn, card: str, calls: int = 3) -> None:
    """Where the device time of ``calls`` serving calls goes: kernel time by
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
        log(f"[5] profile: the profiler saw no device time; breakdown not measured [{card}]")
        return
    log(f"[5] profile of {calls} bf16 serve calls: window {window_us / calls:.1f} us/call, "
        f"kernels {busy_us / calls:.1f} us/call, device idle {1 - busy_us / window_us:.3f} "
        f"of the window [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[5]   {e.self_device_time_total / calls:9.1f} us/call "
            f"{e.count // calls:4d}x  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2

    import numpy as np

    from yolov6_tpu_torch.models.end2end import make_end2end_fn
    from yolov6_tpu_torch.models.yolo import build_model
    from yolov6_tpu_torch.ops import nms as nms_mod
    from yolov6_tpu_torch.ops.cuda import build
    from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov6_tpu_torch.utils.config import Config

    dev = torch.device("cuda")
    card = nvidia_smi_line()

    # ---- 1. card, versions, build
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
        boxes, scores = clustered_candidates(10 + i, B, K, dev)
        idx_k, valid_k = greedy_nms(boxes, scores, md, iou)
        idx_p, valid_p = greedy_nms_plain(boxes, scores, md, iou)
        torch.cuda.synchronize()
        assert torch.equal(valid_k, valid_p), f"{name}: valid differs from the plain keep"
        assert torch.equal(idx_k, idx_p), f"{name}: idx differs from the plain keep"
        n_valid = int(valid_k.sum())
        assert n_valid > B * md // 2, f"{name}: only {n_valid} kept, the chain is too short"
        ms = cuda_ms(lambda: greedy_nms(boxes, scores, md, iou), iters=20)
        plain_ms = cuda_ms(lambda: greedy_nms_plain(boxes, scores, md, iou), iters=3, warmup=1)
        b_ms, b_by = bound_ms(*keep_work(boxes, scores, idx_k, valid_k, iou))
        keep_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"[2] greedy_nms {name} B={B} K={K} max_det={md} iou={iou}: equal to plain, "
            f"{n_valid} kept; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}) [{card}]")

    # ---- 3. the serving path at full width, fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "yolov6s.py"))
    torch.manual_seed(0)
    model = build_model(cfg, num_classes=NUM_CLASSES, deploy=True, device="cuda")
    randomize_weights(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    images_np = np.random.default_rng(0).integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    images = torch.from_numpy(images_np).to(dev)
    serve = make_end2end_fn(model, **SERVE, with_preprocess=True, half=False, device="cuda")

    greedy_nms.launches = 0
    num_dets, boxes, scores, classes = serve(images)
    torch.cuda.synchronize()
    main_launches = greedy_nms.launches
    assert main_launches > 0, "serving did not launch the NMS kernel"
    assert num_dets.shape == (BATCH, 1) and boxes.shape == (BATCH, SERVE["max_det"], 4)
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
    total = int(num_dets.sum())
    assert total > 0, "serving found no detections"
    log(f"[3] served YOLOv6-S ({n_params / 1e6:.2f} M params) b{BATCH}@{IMG} fp32: "
        f"{total} detections, {main_launches} NMS kernel launch(es)")

    def forward_decode(x_uint8, m, half):
        x = x_uint8.permute(0, 3, 1, 2).to(torch.bfloat16 if half else torch.float32)
        x = x.contiguous().flip(1) / 255.0
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=half):
            head, _ = m(x)
        return m.decode(head)

    cpu_model = build_model(cfg, num_classes=NUM_CLASSES, deploy=True, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        preds = forward_decode(images, model, half=False)
        dets_k, valid_k = nms_mod.non_max_suppression(preds, **SERVE)
        dets_p, valid_p = nms_mod.non_max_suppression(preds, **SERVE, method="loop")
        assert torch.equal(valid_k, valid_p) and torch.equal(dets_k, dets_p), \
            "serving: kernel keep differs from the plain keep"
        assert torch.equal(valid_k.sum(1, keepdim=True, dtype=torch.int32), num_dets), \
            "serving: serve() differs from forward + decode + NMS"
        ev_k, ev_valid_k = nms_mod.non_max_suppression(preds, **EVAL)
        ev_p, ev_valid_p = nms_mod.non_max_suppression(preds, **EVAL, method="loop")
        assert torch.equal(ev_valid_k, ev_valid_p) and torch.equal(ev_k, ev_p), \
            "eval protocol: kernel keep differs from the plain keep"
        log(f"[3] same predictions through the plain keep: identical at the serving "
            f"setting and at the eval protocol ({int(ev_valid_k.sum())} detections)")

        # two of the images on the CPU, fp32
        cpu_serve = make_end2end_fn(cpu_model, **SERVE, with_preprocess=True, half=False,
                                    device="cpu")
        cpu_num, _, _, _ = cpu_serve(images_np[:2])
        assert int(cpu_num.sum()) > 0, "CPU serving found no detections"
        preds_cpu = forward_decode(torch.from_numpy(images_np[:2]), cpu_model, half=False)
        preds_gpu = preds[:2].cpu()
        torch.testing.assert_close(preds_cpu[..., :4], preds_gpu[..., :4], **DECODE_BOX_TOL)
        torch.testing.assert_close(preds_cpu[..., 4:], preds_gpu[..., 4:], **DECODE_SCORE_TOL)
        box_err = float((preds_cpu[..., :4] - preds_gpu[..., :4]).abs().max())
        score_err = float((preds_cpu[..., 4:] - preds_gpu[..., 4:]).abs().max())
        log(f"[3] CPU decode of 2 images vs CUDA: max |box| diff {box_err:.3e} px, "
            f"max |score| diff {score_err:.3e} (tolerance boxes {DECODE_BOX_TOL}, "
            f"scores {DECODE_SCORE_TOL}); CPU serve {cpu_num.flatten().tolist()} vs CUDA "
            f"{num_dets[:2].flatten().tolist()} detections")

        # the kernel at the main path's shape, on the main path's own candidates
        _, nms_boxes, cand_scores, _ = nms_mod._select_candidates(
            preds, SERVE["conf_thres"], 30000, False, False, None)
        nms_boxes, cand_scores = nms_boxes.contiguous(), cand_scores.contiguous()
        md, iou = SERVE["max_det"], SERVE["iou_thres"]
        idx_k, valid_k = greedy_nms(nms_boxes, cand_scores, md, iou)
        idx_p, valid_p = greedy_nms_plain(nms_boxes, cand_scores, md, iou)
        assert torch.equal(idx_k, idx_p) and torch.equal(valid_k, valid_p)
        max_abs_err = float((idx_k - idx_p).abs().max())
        main_ms = cuda_ms(lambda: greedy_nms(nms_boxes, cand_scores, md, iou), iters=20)
        main_plain_ms = cuda_ms(lambda: greedy_nms_plain(nms_boxes, cand_scores, md, iou),
                                iters=3, warmup=1)
        main_bound, main_by = bound_ms(*keep_work(nms_boxes, cand_scores, idx_k, valid_k, iou))
        log(f"[3] greedy_nms on the served candidates B={BATCH} K={nms_boxes.shape[1]} "
            f"max_det={md}: kernel {main_ms:.4f} ms, plain {main_plain_ms:.3f} ms, "
            f"bound {main_bound:.5f} ms ({main_by}) [{card}]")

    # ---- 4. times: bf16 serving at b32@640
    torch.backends.cudnn.allow_tf32 = True
    serve16 = make_end2end_fn(model, **SERVE, with_preprocess=True, half=True, device="cuda")
    n16 = serve16(images)[0]
    torch.cuda.synchronize()
    assert int(n16.sum()) > 0, "bf16 serving found no detections"
    with torch.inference_mode():
        fd_ms = cuda_ms(lambda: forward_decode(images, model, half=True), iters=10, warmup=3)
    sv_ms = cuda_ms(lambda: serve16(images), iters=10, warmup=3)
    log(f"[4] bf16 YOLOv6-S b{BATCH}@{IMG}: fwd+decode {fd_ms:.3f} ms = "
        f"{BATCH / fd_ms * 1e3:.1f} imgs/s; fwd+decode+NMS (serve) {sv_ms:.3f} ms = "
        f"{BATCH / sv_ms * 1e3:.1f} imgs/s [{card}]")
    log(f"[4] greedy_nms at the serving shape {keep_rows['serving']['ms']:.4f} ms, at the "
        f"eval-protocol shape {keep_rows['eval_protocol']['ms']:.4f} ms [{card}]")
    profile_serve(lambda: serve16(images), card)

    kernels = [{
        "name": "greedy_nms",
        "route": "cuda",
        "source": "yolov6_tpu_torch/ops/cuda/csrc/nms_kernel.cu",
        "replaces": "yolov6_tpu/ops/pallas/nms_kernel.py:27",
        "launches": main_launches,
        "matches_plain": True,
        "max_abs_err": max_abs_err,
        "ms": main_ms,
        "plain_ms": main_plain_ms,
        "bound_ms": main_bound,
        "bound_by": main_by,
        "library_ms": None,
        "shape": f"B={BATCH} K={nms_boxes.shape[1]} max_det={md}",
        "shapes": {name: dict(B=B, K=K, max_det=m, **keep_rows[name])
                   for name, B, K, m, _ in KEEP_SHAPES},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
