"""Greedy NMS keep: the CUDA kernel's wrapper and its plain torch version.

The kernel (csrc/nms_kernel.cu) replaces the Pallas TPU kernel
yolov6_tpu/ops/pallas/nms_kernel.py::_nms_kernel. See the source for what
bounds it on the H100 and how its design answers that.

Both versions take ``boxes [B, K, 4]`` (xyxy, class offset applied) and
``scores [B, K]`` (0 below conf), and return ``idx [B, max_det] int32`` (the
candidate kept at each step, 0 on an invalid row) and ``valid [B, max_det]
bool``. The 128-lane rows of the TPU kernel are a VMEM layout; the caller
gathers boxes and classes by ``idx``.
"""

from __future__ import annotations

import ctypes

import torch

# dynamic shared memory a block may use on sm_90 (232,448 bytes), less the
# kernel's static reduction scratch
MAX_K = (232448 - 1024) // 4


def greedy_nms_plain(boxes: torch.Tensor, scores: torch.Tensor, max_det: int,
                     iou_thres: float):
    """The batched torch loop of yolov6_tpu/ops/nms.py:70-91, with the same
    IoU expression. The reference for the kernel, and the keep on the CPU."""
    B = boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    alive = scores > 0.0
    rows = torch.arange(B, device=boxes.device)
    idx = torch.zeros((B, max_det), dtype=torch.int32, device=boxes.device)
    valid = torch.zeros((B, max_det), dtype=torch.bool, device=boxes.device)
    for i in range(max_det):
        masked = torch.where(alive, scores, -1.0)
        cur = masked.argmax(1)
        ok = masked[rows, cur] > 0.0
        cb = boxes[rows, cur]
        iw = (torch.minimum(cb[:, 2:3], x2) - torch.maximum(cb[:, 0:1], x1)).clamp(min=0)
        ih = (torch.minimum(cb[:, 3:4], y2) - torch.maximum(cb[:, 1:2], y1)).clamp(min=0)
        inter = iw * ih
        iou = inter / (areas[rows, cur][:, None] + areas - inter + 1e-12)
        alive &= ~((iou > iou_thres) & ok[:, None])
        idx[:, i] = torch.where(ok, cur, 0).to(torch.int32)
        valid[:, i] = ok
    return idx, valid


def _lib():
    from yolov6_tpu_torch.ops.cuda import build

    lib = build.load("nms_kernel")
    fn = lib.yolov6_greedy_nms
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.yolov6_cuda_error_string.argtypes = [ctypes.c_int]
        lib.yolov6_cuda_error_string.restype = ctypes.c_char_p
    return lib


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, max_det: int,
               iou_thres: float):
    """Greedy NMS keep: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. Counts kernel launches in ``greedy_nms.launches``."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"need boxes [B,K,4] and scores [B,K], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(f"need float32 boxes and scores, got {boxes.dtype}, {scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    B, K = scores.shape
    if B < 1 or K < 1 or max_det < 1:
        raise ValueError(f"empty NMS problem: B={B}, K={K}, max_det={max_det}")
    if boxes.device.type == "cpu":
        return greedy_nms_plain(boxes, scores, max_det, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    if K > MAX_K:
        raise ValueError(f"K={K} candidates exceed the kernel's shared-memory limit {MAX_K}")
    lib = _lib()
    idx = torch.empty((B, max_det), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((B, max_det), dtype=torch.bool, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.yolov6_greedy_nms(boxes.data_ptr(), scores.data_ptr(), B, K, max_det,
                                    float(iou_thres), idx.data_ptr(), valid.data_ptr(),
                                    stream)
    if err != 0:
        raise RuntimeError(f"greedy_nms kernel launch failed: "
                           f"{lib.yolov6_cuda_error_string(err).decode()}")
    greedy_nms.launches += 1
    return idx, valid


greedy_nms.launches = 0
