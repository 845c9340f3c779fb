"""Greedy NMS keep: the registered op ``yolov6::greedy_nms``, its CUDA
kernel's launch and its plain torch version.

The kernel (csrc/nms_kernel.cu) replaces two TPU-side keeps of the JAX
package: the Pallas kernel yolov6_tpu/ops/pallas/nms_kernel.py::_nms_kernel
and, under the default rule, yolov6_tpu/ops/nms.py::_tiled_keep with
_emit_topk_kept. See the source for what bounds it on the H100 and how its
design answers that.

The keep is a ``torch.library`` custom op, so that ``torch.export`` and
``torch.jit.trace`` record it as one node and a loaded artifact launches the
kernel (the JAX artifact carries its Pallas kernel the same way). Its CUDA
implementation launches the kernel, its CPU implementation is the plain
version, and its fake implementation gives the output shapes; there is no
other. The op's precondition: the positive scores of each image form a
non-increasing prefix (the order ``non_max_suppression`` hands over); it
checks its inputs' shapes and types on every device. ``greedy_nms``, the
wrapper for other callers, stable-sorts the candidates first and maps
``idx`` back.

Both versions take ``boxes [B, K, 4]`` (xyxy, class offset applied) and
``scores [B, K]`` (0 below conf), and return ``idx [B, max_det] int32`` (the
candidate kept at each step, 0 on an invalid row) and ``valid [B, max_det]
bool``. The 128-lane rows of the TPU kernel are a VMEM layout; the caller
gathers boxes and classes by ``idx``.

The rule (``emit_once``) decides what happens to a kept box whose IoU with
itself is not above the threshold (zero area, or inverted):

  - ``emit_once=True``, the default rule of the JAX package's default keep
    (``'tiled'``) and of upstream's ``torchvision.ops.nms``: every kept box
    leaves the alive set, so each box is emitted at most once;
  - ``emit_once=False``, the Pallas rule (``_nms_kernel`` and the JAX
    ``'loop'``): such a box stays the argmax and fills every remaining row.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# dynamic shared memory a block may use on sm_90 (232,448 bytes), less the
# kernel's static scratch
SMEM_LIMIT = 232448 - 1024
TILE = 128  # candidates per tile of the kernel's tile walk (kTile in the source)


def greedy_nms_plain(boxes: torch.Tensor, scores: torch.Tensor, max_det: int,
                     iou_thres: float, emit_once: bool = True):
    """The batched torch loop of yolov6_tpu/ops/nms.py:70-91, with the same
    IoU expression, under either rule. The reference for the kernel, and the
    keep on the CPU. On candidates sorted by descending score (ties in index
    order), ``emit_once=True`` equals ``_tiled_keep`` + ``_emit_topk_kept``."""
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
        if emit_once:
            alive[rows, cur] = False
        idx[:, i] = torch.where(ok, cur, 0).to(torch.int32)
        valid[:, i] = ok
    return idx, valid


def _lib():
    from yolov6_tpu_torch.ops.cuda import build

    lib = build.load("nms_kernel")
    fn = lib.yolov6_greedy_nms
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.yolov6_greedy_nms_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.yolov6_greedy_nms_smem_bytes.restype = ctypes.c_int
        lib.yolov6_greedy_nms_init.argtypes = [ctypes.c_int]
        lib.yolov6_greedy_nms_init.restype = ctypes.c_int
        lib.yolov6_cuda_error_string.argtypes = [ctypes.c_int]
        lib.yolov6_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _smem_bytes(K: int, max_det: int) -> int:
    return _lib().yolov6_greedy_nms_smem_bytes(K, max_det)


@functools.lru_cache(maxsize=None)
def _init_device(index: int) -> None:
    """Allow launches on device ``index`` up to SMEM_LIMIT of dynamic shared
    memory, once per device (the caller has made it current)."""
    lib = _lib()
    err = lib.yolov6_greedy_nms_init(SMEM_LIMIT)
    if err != 0:
        raise RuntimeError(f"greedy_nms: setting the shared-memory limit failed: "
                           f"{lib.yolov6_cuda_error_string(err).decode()}")


def _check(boxes: torch.Tensor, scores: torch.Tensor, max_det: int) -> None:
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


@torch.library.custom_op("yolov6::greedy_nms", mutates_args=(), device_types="cpu")
def greedy_nms_op(boxes: torch.Tensor, scores: torch.Tensor, max_det: int, iou_thres: float,
                  emit_once: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The keep on candidates in the op's order (module doc). On the CPU:
    the plain version."""
    _check(boxes, scores, max_det)
    return greedy_nms_plain(boxes, scores, max_det, iou_thres, emit_once)


@greedy_nms_op.register_kernel("cuda")
def _greedy_nms_cuda(boxes, scores, max_det, iou_thres, emit_once):
    """The kernel's launch on the current stream of the tensors' device.
    Counts the launch in ``greedy_nms.launches`` and leaves the tiles each
    image visited in ``greedy_nms.last_tiles`` ([B] int32 on the device, to
    be read after a synchronise). A failed build or launch raises."""
    _check(boxes, scores, max_det)
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (the kernel reads them as float4)")
    B, K = scores.shape
    smem = _smem_bytes(K, max_det)
    if smem > SMEM_LIMIT:
        raise ValueError(f"max_det={max_det} needs {smem} bytes of shared memory, more than "
                         f"the kernel's {SMEM_LIMIT} (20 bytes a kept box for min(K, max_det))")
    idx = torch.empty((B, max_det), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((B, max_det), dtype=torch.bool, device=boxes.device)
    tiles = torch.empty((B,), dtype=torch.int32, device=boxes.device)
    lib = _lib()
    with torch.cuda.device(boxes.device):
        _init_device(torch.cuda.current_device())
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.yolov6_greedy_nms(boxes.data_ptr(), scores.data_ptr(), B, K, max_det,
                                    float(iou_thres), int(bool(emit_once)), idx.data_ptr(),
                                    valid.data_ptr(), tiles.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"greedy_nms kernel launch failed: "
                           f"{lib.yolov6_cuda_error_string(err).decode()}")
    greedy_nms.launches += 1
    greedy_nms.last_tiles = tiles
    return idx, valid


@greedy_nms_op.register_fake
def _greedy_nms_fake(boxes, scores, max_det, iou_thres, emit_once):
    _check(boxes, scores, max_det)
    B = boxes.shape[0]
    return (boxes.new_empty((B, max_det), dtype=torch.int32),
            boxes.new_empty((B, max_det), dtype=torch.bool))


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, max_det: int,
               iou_thres: float, emit_once: bool = True):
    """Greedy NMS keep on candidates in any order: stable-sorted by
    descending score, kept by ``yolov6::greedy_nms`` (the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor; any other device
    raises), ``idx`` mapped back to the caller's order. The sort keeps what
    the greedy loop keeps in any order. Counts kernel launches in
    ``greedy_nms.launches``, also those made from a loaded artifact."""
    _check(boxes, scores, max_det)
    B, K = scores.shape
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    boxes = boxes.gather(1, order[..., None].expand(B, K, 4)).contiguous()
    idx, valid = greedy_nms_op(boxes, scores.contiguous(), max_det, float(iou_thres),
                               bool(emit_once))
    idx = torch.where(valid, order.gather(1, idx.long()), 0).to(torch.int32)
    return idx, valid


greedy_nms.launches = 0
greedy_nms.last_tiles = None
