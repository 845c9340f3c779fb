"""The port's train-mode dataset and loader (yolov6_tpu_torch/data/datasets.py,
data/data_load.py) against the JAX package's native train path, on the CPU,
on a small PNG set of mixed sizes at img_size 64.

Tolerance: none. With the JAX package's ``random``/``np.random`` seeded as
the port's per-sample ``Draws`` (``sample_seed(seed, epoch, index)``), a
train sample (mosaic with and without mixup, and the letterbox + affine
branch, each with the HSV jitter and the flips) has the JAX sample's pixels,
labels and shapes. The loader's order for a (seed, epoch) is the JAX
``DataLoader._indices``, and its batches (``drop_last``, label padding,
``n_valid``) equal the JAX loader's.
"""

import random

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.data.data_load import DataLoader as JaxDataLoader
from yolov6_tpu.data.datasets import TrainValDataset as JaxDataset

from yolov6_tpu_torch.data.data_augment import sample_seed
from yolov6_tpu_torch.data.data_load import DataLoader, create_dataloader
from yolov6_tpu_torch.data.datasets import TrainValDataset
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.utils.data_config import load_data_config

IMG, SEED = 64, 3
# enlarged (INTER_LINEAR), shrunk (INTER_LINEAR too in train mode), and as is
SIZES = [(96, 72), (80, 96), (120, 90), (50, 64), (64, 64), (33, 47)]


def _hyp(mosaic, mixup=0.0):
    return dict(mosaic=mosaic, mixup=mixup, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=5.0,
                translate=0.1, scale=0.5, shear=1.0, flipud=0.5, fliplr=0.5)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    return load_data_config(generate_synth_dataset(
        str(root), n_train=12, n_val=0, img_size=IMG, nc=4, seed=5, sizes=SIZES))


def _pair(data, hyp, **kw):
    ours = TrainValDataset(data["train"], img_size=IMG, batch_size=4, augment=True, hyp=hyp,
                           task="train", data_dict=dict(data), seed=SEED, **kw)
    theirs = JaxDataset(data["train"], img_size=IMG, batch_size=4, augment=True, hyp=hyp,
                        task="train", data_dict=dict(data), **kw)
    assert theirs._native_aug
    return ours, theirs


@pytest.mark.parametrize("mosaic,mixup", [(1.0, 0.0), (1.0, 1.0), (0.0, 0.0)],
                         ids=["mosaic", "mosaic_mixup", "letterbox_affine"])
def test_train_sample_equals_jax_native_path(data, mosaic, mixup):
    ours, theirs = _pair(data, _hyp(mosaic, mixup))
    for epoch in (0, 2):
        ours.epoch = epoch
        for index in range(len(ours)):
            seed = sample_seed(SEED, epoch, index)
            random.seed(seed)
            np.random.seed(seed)
            img_j, labels_j, path_j, shapes_j = theirs[index]
            img, labels, path, shapes = ours[index]
            assert img.shape == (IMG, IMG, 3) and img.dtype == np.uint8
            np.testing.assert_array_equal(img, img_j)
            np.testing.assert_array_equal(labels, labels_j)
            assert labels.dtype == np.float32 and path == path_j and shapes == shapes_j
            if len(labels):
                assert 0 <= labels[:, 1:].min() and labels[:, 1:].max() <= 1


def test_train_sample_does_not_depend_on_the_thread_or_the_call_order(data):
    ours, _ = _pair(data, _hyp(1.0, 0.5))
    first = [ours[i] for i in range(len(ours))]
    again = [ours[i] for i in reversed(range(len(ours)))][::-1]
    for (a, la, *_), (b, lb, *_) in zip(first, again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    ours.epoch = 1
    assert any(not np.array_equal(ours[i][0], first[i][0]) for i in range(len(ours)))


def test_train_mode_loads_with_inter_linear_whatever_the_size(data):
    import cv2

    ours, _ = _pair(data, _hyp(0.0))
    for index, path in enumerate(ours.img_paths):
        img, (h0, w0), (h, w) = ours.load_image_rgb(index)
        bgr = cv2.imread(path)
        r = IMG / max(h0, w0)
        want = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if (int(h0 * r), int(w0 * r)) != (h0, w0):
            want = cv2.resize(want, (int(w0 * r), int(h0 * r)), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 3), (7, 1)])
def test_loader_order_equals_jax(data, seed, epoch):
    ours = DataLoader(TrainValDataset(data["train"], img_size=IMG), 4, shuffle=True, seed=seed)
    theirs = JaxDataLoader(JaxDataset(data["train"], img_size=IMG), 4, shuffle=True, seed=seed)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    assert ours._indices() == theirs._indices()
    assert ours.dataset.epoch == epoch


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_equal_jax(data, drop_last):
    """Eval-mode samples (no draws), shuffled: the batch order, the dropped or
    padded tail, the label padding and n_valid are the JAX loader's."""
    kw = dict(shuffle=True, seed=2, drop_last=drop_last, max_labels=3, num_workers=3)
    ours = DataLoader(TrainValDataset(data["train"], img_size=IMG), 5, **kw)
    theirs = JaxDataLoader(JaxDataset(data["train"], img_size=IMG), 5, **kw)
    ours.set_epoch(1)
    theirs.set_epoch(1)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(ours) == len(theirs) == (2 if drop_last else 3)
    for (imgs, labels, paths, shapes, n), (imgs_j, labels_j, paths_j, shapes_j, n_j) in zip(
            got, want):
        np.testing.assert_array_equal(imgs, imgs_j)
        np.testing.assert_array_equal(labels, labels_j)
        assert paths == paths_j and shapes == shapes_j and n == n_j


def test_create_dataloader_augment_shuffles_and_drops_last(data):
    loader, dataset = create_dataloader(data["train"], IMG, 5, hyp=_hyp(1.0), augment=True,
                                        data_dict=dict(data), seed=4, num_workers=2)
    assert loader.shuffle and loader.drop_last and dataset.augment and dataset.seed == 4
    batches = list(loader)
    assert len(batches) == len(loader) == 2
    assert all(b[4] == 5 and b[0].shape == (5, IMG, IMG, 3) for b in batches)
    again = list(loader)
    for a, b in zip(batches, again):
        np.testing.assert_array_equal(a[0], b[0])
    eval_loader, _ = create_dataloader(data["train"], IMG, 5, data_dict=dict(data))
    assert not eval_loader.shuffle and not eval_loader.drop_last and len(eval_loader) == 3


@pytest.mark.parametrize("kw", [dict(rect=True), dict(hyp=dict(_hyp(1.0), shrink_size=4))],
                         ids=str)
def test_augment_refuses_what_the_train_path_lacks(data, kw):
    kw = dict(dict(hyp=_hyp(1.0)), **kw)
    with pytest.raises(ValueError, match="augment=True takes no"):
        TrainValDataset(data["train"], img_size=IMG, augment=True, **kw)
