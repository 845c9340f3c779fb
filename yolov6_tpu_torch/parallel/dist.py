"""Data parallelism over ``torch.distributed``: one process a rank (port of
yolov6_tpu/parallel/mesh.py).

The JAX package trains one GSPMD program over a 1-D mesh; here each rank
runs the step on its slice of the global batch and the ranks meet in a few
collectives: the flat gradient's sum and the logged losses'
(``core/train_step.py``), the BatchNorm statistics (``layers/sync_bn.py``),
the loss normalisers (``losses/``), and the in-training eval's COCO rows
(``core/evaler.py::gather_coco_predictions``). With no process group every
helper here is the identity and nothing is exchanged; in a group of one the
collectives run and change no value.

A collective's tensors must sit on the backend's device: NCCL takes CUDA
tensors on the rank's card, gloo takes CPU tensors (it would stage a CUDA
tensor through the host anyway). ``_comm`` applies that rule once for every
helper: a tensor elsewhere is copied there and back.
"""

from __future__ import annotations

import os
from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """True when a process group is initialised (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main_process() -> bool:
    """Rank 0 logs, writes the run's files and scores the eval."""
    return rank() == 0


def process_shard_info():
    """``(shard_id, num_shards)`` for the loaders (JAX: mesh.py:72-77)."""
    return rank(), world_size()


def initialize_distributed(device="cuda") -> torch.device:
    """Join torchrun's process group and return the rank's device.

    ``WORLD_SIZE > 1`` in the environment (torchrun sets it with ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) initialises the
    group: NCCL when ``device`` is CUDA, gloo when the caller asked for the
    CPU. A group the caller already initialised is used as it is, whatever
    its backend (two gloo ranks may share one card). Without either, one
    process, nothing is initialised. Non-main ranks then log warnings only."""
    device = torch.device(device)
    if not is_distributed() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    device = rank_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)  # before the first collective
    from yolov6_tpu_torch.utils.events import set_logging

    set_logging()
    return device


def rank_device(device) -> torch.device:
    """The rank's device: under NCCL ``cuda`` means ``cuda:{LOCAL_RANK}``, and a
    rank without a card of its own raises. Under gloo, or with no group, the
    device is returned as given."""
    device = torch.device(device)
    if device.type != "cuda" or not is_distributed() or dist.get_backend() != "nccl":
        return device
    local = int(os.environ.get("LOCAL_RANK", "0")) if device.index is None else device.index
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank()} (LOCAL_RANK {local}) has no card of its own: NCCL "
                           f"needs one card a rank, this host has {torch.cuda.device_count()}")
    return torch.device("cuda", local)


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _comm(t: torch.Tensor, op) -> torch.Tensor:
    """Run ``op`` on ``t`` in place, through a copy on the backend's device
    when ``t`` sits elsewhere."""
    dev = _comm_device()
    if t.device == dev and t.is_contiguous():
        op(t)
        return t
    buf = t.detach().to(dev).contiguous()
    op(buf)
    with torch.no_grad():
        t.copy_(buf)
    return t


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (returns ``t``)."""
    if not is_distributed():
        return t
    return _comm(t, lambda x: dist.all_reduce(x, op=dist.ReduceOp.SUM))


def all_reduce_max_(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elementwise maximum over the ranks, in place."""
    if not is_distributed():
        return t
    return _comm(t, lambda x: dist.all_reduce(x, op=dist.ReduceOp.MAX))


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    if not is_distributed():
        return t
    return _comm(t, lambda x: dist.broadcast(x, src))


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, device=_comm_device())
    return box[0]


def all_gather_rows(rows: np.ndarray) -> List[np.ndarray]:
    """Every rank's ``[n_r, ...]`` float64 rows, in rank order (each rank
    may hold another ``n_r``): the counts, then the rows padded to the
    largest count, gathered and trimmed."""
    rows = np.asarray(rows, np.float64)
    if not is_distributed():
        return [rows]
    dev = _comm_device()
    n = torch.tensor([len(rows)], dtype=torch.int64, device=dev)
    counts = [torch.zeros_like(n) for _ in range(world_size())]
    dist.all_gather(counts, n)
    counts = [int(c) for c in counts]
    padded = torch.zeros((max(1, max(counts)),) + rows.shape[1:], dtype=torch.float64,
                         device=dev)
    padded[:len(rows)] = torch.from_numpy(rows).to(dev)
    parts = [torch.empty_like(padded) for _ in counts]
    dist.all_gather(parts, padded)
    return [p[:c].cpu().numpy() for p, c in zip(parts, counts)]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks without a gradient: a loss normaliser taken
    over the global batch, as the JAX step's GSPMD sum takes it. A process
    without a group gets ``t`` itself, so that its step stays as it was bit
    for bit."""
    if not is_distributed():
        return t
    return all_reduce_sum_(t.detach().clone())


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose gradient is again the sum over the
    ranks: every rank's loss reads the sum, and the step adds the ranks'
    gradients."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.clone())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiably (``t`` without a group)."""
    if not is_distributed():
        return t
    return _AllReduceSum.apply(t)
