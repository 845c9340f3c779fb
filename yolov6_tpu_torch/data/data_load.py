"""Batched host data pipeline (port of yolov6_tpu/data/data_load.py:24-136,
206-266).

Fixed-shape batches: the last partial batch is padded by repeating its last
sample and carries the count of real ones, so the eval function sees one
batch shape; a training loader shuffles with the JAX permutation
(``random.Random(seed + epoch).shuffle``) and drops the partial batch. A
thread pool decodes the samples (zlib and most numpy operations release the
GIL; the Python around them holds it) and fills a bounded queue; an error in
it reaches the consumer. With
``pin_memory`` the image batch is collated straight into pinned host memory,
so that the copy to the card can be non-blocking (the port's replacement for
the JAX package's ``prefetch_to_device``).
"""

from __future__ import annotations

import queue
import random
import threading
from multiprocessing.pool import ThreadPool
from typing import Iterator, Optional

import numpy as np
import torch

from yolov6_tpu_torch.data.datasets import TrainValDataset


class DataLoader:
    """Iterates fixed-shape ``(imgs, labels, paths, shapes, n_valid)`` batches.

    imgs: uint8 ``[B, H, W, 3]`` RGB, a numpy array, or with ``pin_memory`` a
    pinned CPU tensor. labels: float32 ``[B, max_labels, 5]`` (cls, cx, cy, w,
    h normalised) padded with class -1. n_valid: the number of real samples
    in the batch.
    """

    def __init__(
        self,
        dataset: TrainValDataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 4,
        max_labels: int = 120,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        drop_last: bool = False,
        prefetch: int = 4,
        pad_shards: bool = True,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.max_labels = max_labels
        self.seed = seed
        self.epoch = 0
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pad_shards = pad_shards
        self.pin_memory = pin_memory

    def set_epoch(self, epoch: int) -> None:
        """The epoch of the next iteration: it sets the permutation and the
        dataset's per-sample draws."""
        self.epoch = epoch
        self.dataset.epoch = epoch

    def _indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        # a contiguous shard; pad_shards=False drops the wrap-around fill,
        # which eval needs so that no detection is counted twice
        if self.num_shards > 1:
            per = int(np.ceil(len(idx) / self.num_shards))
            lo = self.shard_id * per
            idx = (idx * 2)[lo: lo + per] if self.pad_shards else idx[lo: lo + per]
        return idx

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else int(np.ceil(n / self.batch_size))

    def _collate(self, samples):
        n_valid = len(samples)
        while len(samples) < self.batch_size:
            samples.append(samples[-1])
        if self.pin_memory:
            imgs = torch.empty((self.batch_size,) + samples[0][0].shape, dtype=torch.uint8,
                               pin_memory=True)
            buf = imgs.numpy()
            for i, s in enumerate(samples):
                buf[i] = s[0]
        else:
            imgs = np.stack([s[0] for s in samples])
        labels = np.full((self.batch_size, self.max_labels, 5), -1.0, np.float32)
        labels[..., 1:] = 0.0
        for i, s in enumerate(samples):
            lb = s[1][: self.max_labels]
            if len(lb):
                labels[i, : len(lb)] = lb
        paths = [s[2] for s in samples]
        shapes = [s[3] for s in samples]
        return imgs, labels, paths, shapes, n_valid

    def __iter__(self) -> Iterator:
        indices = self._indices()
        batches = [indices[i: i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Put unless the consumer has gone; True when it was put."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                with ThreadPool(self.num_workers) as pool:
                    for batch_idx in batches:
                        samples = pool.map(self.dataset.__getitem__, batch_idx)
                        if not put(self._collate(samples)):
                            return
            except Exception as e:  # the consumer raises it
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=worker, daemon=True, name="data-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=60)


def create_dataloader(
    path: str,
    img_size: int,
    batch_size: int,
    *,
    stride: int = 32,
    hyp: Optional[dict] = None,
    augment: bool = False,
    pad: float = 0.0,
    rect: bool = False,
    data_dict: Optional[dict] = None,
    task: str = "train",
    specific_shape: bool = False,
    height: Optional[int] = None,
    width: Optional[int] = None,
    num_workers: int = 8,
    max_labels: int = 120,
    shard_id: int = 0,
    num_shards: int = 1,
    pad_shards: bool = True,
    pin_memory: bool = False,
    seed: int = 0,
    cache: Optional[str] = None,
    check_images: bool = False,
    check_labels: bool = False,
):
    """The loader over ``path`` (reference: data_load.py:206-266). With
    ``augment`` the dataset augments and the loader shuffles and drops the
    last partial batch, as the JAX package's does; ``seed`` seeds the
    permutation and the dataset's draws. ``shard_id``/``num_shards`` give a
    rank its contiguous shard of the (shuffled) indices; ``cache`` (``"ram"``
    or ``"disk"``) keeps the train path's decoded images;
    ``specific_shape`` with ``height``/``width`` sets the samples' shape, and
    ``check_images``/``check_labels`` the scan's checks
    (``TrainValDataset``). Returns ``(loader, dataset)``."""
    dataset = TrainValDataset(
        path, img_size=img_size, batch_size=batch_size, augment=augment, hyp=hyp, rect=rect,
        stride=stride, pad=pad, data_dict=data_dict, task=task, specific_shape=specific_shape,
        height=height, width=width, seed=seed, cache=cache, check_images=check_images,
        check_labels=check_labels,
    )
    loader = DataLoader(
        dataset, batch_size=batch_size, shuffle=augment, num_workers=num_workers,
        max_labels=max_labels, seed=seed, shard_id=shard_id, num_shards=num_shards,
        drop_last=augment, pad_shards=pad_shards, pin_memory=pin_memory,
    )
    return loader, dataset
