"""The train path's image caches (yolov6_tpu_torch/data/datasets.py,
``cache="ram"|"disk"``; the JAX package's tiers, datasets.py:143-182,
374-460) on the CPU, on a small PNG set of mixed sizes at img_size 64.

Tolerance: none. Over two epochs, with mosaic and mixup on, every batch of a
cached loader (images, labels, paths, shapes, valid counts) equals the
uncached loader's bit for bit; the second epoch decodes no image (the first
decodes each at most once a thread); two processes that fill one disk tier
at once read back batches equal to the uncached ones, and the tier holds
one whole ``.npy`` an image and no temporary file.
"""

import os

import numpy as np
import pytest

from yolov6_tpu_torch.data import datasets
from yolov6_tpu_torch.data.data_load import create_dataloader
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.utils.data_config import load_data_config

from torch_dist_utils import run_ranks

IMG, SEED, N = 64, 3, 12
SIZES = [(96, 72), (80, 96), (120, 90), (50, 64), (64, 64), (33, 47)]
HYP = dict(mosaic=1.0, mixup=0.5, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=5.0,
           translate=0.1, scale=0.5, shear=1.0, flipud=0.5, fliplr=0.5)


@pytest.fixture()
def data(tmp_path):
    return load_data_config(generate_synth_dataset(
        str(tmp_path), n_train=N, n_val=0, img_size=IMG, nc=4, seed=5, sizes=SIZES))


def epochs(data, cache, n_epochs=2):
    """Every batch of ``n_epochs`` epochs of the augmenting train loader."""
    loader, _ = create_dataloader(data["train"], IMG, 4, hyp=dict(HYP), augment=True,
                                  data_dict=dict(data), task="train", num_workers=3,
                                  max_labels=8, seed=SEED, cache=cache)
    out = []
    for epoch in range(n_epochs):
        loader.set_epoch(epoch)
        out.append([tuple(b) for b in loader])
    return out


def assert_equal_batches(got, want):
    assert len(got) == len(want)
    for e_got, e_want in zip(got, want):
        assert len(e_got) == len(e_want) > 0
        for (img, lab, paths, shapes, n), (img_w, lab_w, paths_w, shapes_w, n_w) in zip(
                e_got, e_want):
            np.testing.assert_array_equal(img, img_w)
            np.testing.assert_array_equal(lab, lab_w)
            assert paths == paths_w and shapes == shapes_w and n == n_w


@pytest.mark.parametrize("cache", ["ram", "disk"])
def test_cached_batches_equal_uncached_and_epoch_two_reads_the_cache(data, cache, monkeypatch):
    want = epochs(data, None)
    decodes = []
    imread = datasets.imread

    def counting_imread(path):
        decodes.append(path)
        return imread(path)

    monkeypatch.setattr(datasets, "imread", counting_imread)
    loader, dataset = create_dataloader(data["train"], IMG, 4, hyp=dict(HYP), augment=True,
                                        data_dict=dict(data), task="train", num_workers=3,
                                        max_labels=8, seed=SEED, cache=cache)
    got = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        got.append([tuple(b) for b in loader])
        if epoch == 0:
            first = list(decodes)
    assert_equal_batches(got, want)
    assert 0 < len(set(first)) <= N and len(first) <= 3 * N  # at most once a thread
    assert decodes == first, "the second epoch decoded images"
    if cache == "disk":
        files = os.listdir(dataset.disk_cache_dir)
        assert len(files) == len(set(first)) and all(f.endswith(".rgb.npy") for f in files)


def _fill_disk_tier(rank, world, data):
    return epochs(data, "disk")


def test_two_processes_share_the_disk_tier(data):
    want = epochs(data, None)
    for got in run_ranks(_fill_disk_tier, 2, data):
        assert_equal_batches(got, want)
    loader, dataset = create_dataloader(data["train"], IMG, 4, hyp=dict(HYP), augment=True,
                                        data_dict=dict(data), task="train", cache="disk")
    files = os.listdir(dataset.disk_cache_dir)
    assert len(files) == N and all(f.endswith(".rgb.npy") for f in files)


def test_cache_takes_the_train_path_only(data):
    with pytest.raises(ValueError, match="augment=True"):
        datasets.TrainValDataset(data["train"], img_size=IMG, cache="ram")
    with pytest.raises(ValueError, match="'ram' or 'disk'"):
        datasets.TrainValDataset(data["train"], img_size=IMG, augment=True, hyp=dict(HYP),
                                 cache="gpu")
