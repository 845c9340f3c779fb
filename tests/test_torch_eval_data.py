"""The port's eval data path (yolov6_tpu_torch/data/{datasets,data_load,
synth_detect}.py, utils/data_config.py) against the JAX package's, on one
PNG set written by the port's generator and read by both packages.

Tolerances: images equal exactly where no pixel is resized, within 1 where
one is (cv2's fixed-point resizers; tests/test_torch_letterbox.py); labels
and shapes equal to 1e-9 in float64; paths, order, batch shapes and the COCO
ground-truth JSON equal.
"""

import json
import os

import numpy as np
import pytest
import yaml

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.data.data_load import create_dataloader as jax_create_dataloader
from yolov6_tpu.data.datasets import TrainValDataset as JaxTrainValDataset
from yolov6_tpu.data.synth_detect import generate_synth_dataset as jax_generate_synth_dataset

from yolov6_tpu_torch.data.data_load import create_dataloader
from yolov6_tpu_torch.data.datasets import TrainValDataset
from yolov6_tpu_torch.data.image_io import imread
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.utils.data_config import load_data_config

from torch_port_utils import EVAL_IMG_SIZE, EVAL_SIZES, REPO_ROOT

TOL = dict(rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def synth_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalset")
    data_json = generate_synth_dataset(str(root), n_train=0, n_val=len(EVAL_SIZES) + 1,
                                       img_size=EVAL_IMG_SIZE, seed=3, sizes=EVAL_SIZES)
    return load_data_config(data_json)


def _pair(data, **kw):
    """The port's and the JAX package's dataset over the set, each with its
    own copy of the data dict."""
    kw.setdefault("img_size", EVAL_IMG_SIZE)
    kw.setdefault("task", "val")
    ours = TrainValDataset(data["val"], data_dict=dict(data), **kw)
    theirs = JaxTrainValDataset(data["val"], data_dict=dict(data), **kw)
    return ours, theirs


def _assert_items_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        img, labels, path, shapes = ours[i]
        img_j, labels_j, path_j, shapes_j = theirs[i]
        assert path == path_j and img.shape == img_j.shape and img.dtype == np.uint8
        (h0, w0), ((ry, rx), pad) = shapes
        resized = (h0, w0) != ours.load_image(i, ours.hyp.get("shrink_size"))[2]
        diff = np.abs(img.astype(np.int32) - img_j)
        assert diff.max() <= (1 if resized else 0), (path, int(diff.max()))
        assert (h0, w0) == shapes_j[0] and pad == shapes_j[1][1]
        np.testing.assert_allclose(np.float64([ry, rx]), np.float64(shapes_j[1][0]), **TOL)
        np.testing.assert_allclose(np.float64(labels), np.float64(labels_j), **TOL)


def test_dataset_items_match_jax(synth_set):
    _assert_items_equal(*_pair(synth_set))


def test_dataset_items_match_jax_with_shrink_size(synth_set):
    ours, theirs = _pair(synth_set, hyp={"shrink_size": 6})
    assert max(ours[0][0].shape[:2]) == EVAL_IMG_SIZE  # padded back to the target
    _assert_items_equal(ours, theirs)


def test_rect_order_and_batch_shapes_match_jax(synth_set):
    ours, theirs = _pair(synth_set, rect=True, pad=0.5, batch_size=4)
    assert ours.img_paths == theirs.img_paths
    assert len(ours.batch_shapes) == len(theirs.batch_shapes) == 3
    for a, b in zip(ours.batch_shapes, theirs.batch_shapes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.batch_indices, theirs.batch_indices)
    assert {tuple(s) for s in ours.batch_shapes} != {(EVAL_IMG_SIZE, EVAL_IMG_SIZE)}
    _assert_items_equal(ours, theirs)


def test_coco_ground_truth_json_matches_jax(synth_set):
    ours, theirs = _pair(synth_set)
    gt, gt_j = ours.data_dict["anno_path"], theirs.data_dict["anno_path"]
    assert gt != gt_j and os.path.dirname(gt) == os.path.dirname(gt_j)  # no collision
    with open(gt) as f, open(gt_j) as g:
        ours_json, theirs_json = json.load(f), json.load(g)
    assert ours_json == theirs_json
    assert [a["id"] for a in ours_json["annotations"]][:1] == [1]


@pytest.mark.parametrize("shard", [None, (1, 3, True), (2, 3, False)],
                         ids=["whole", "shard1of3_padded", "shard2of3"])
def test_dataloader_batches_match_jax(synth_set, shard):
    kw = dict(img_size=EVAL_IMG_SIZE, batch_size=4, data_dict=None, task="val",
              num_workers=3, max_labels=5)
    if shard:
        kw.update(shard_id=shard[0], num_shards=shard[1], pad_shards=shard[2])
    ours, _ = create_dataloader(synth_set["val"], **kw)
    theirs, _ = jax_create_dataloader(synth_set["val"], **kw)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(ours) > 0
    for (imgs, labels, paths, shapes, n), (imgs_j, labels_j, paths_j, shapes_j, n_j) in zip(
            got, want):
        assert imgs.shape == imgs_j.shape and imgs.dtype == np.uint8
        assert np.abs(imgs.astype(np.int32) - imgs_j).max() <= 1
        np.testing.assert_array_equal(labels, labels_j)
        assert paths == paths_j and n == n_j
        assert [s[0] for s in shapes] == [s[0] for s in shapes_j]
        assert [s[1][1] for s in shapes] == [s[1][1] for s in shapes_j]
        np.testing.assert_allclose([s[1][0] for s in shapes], [s[1][0] for s in shapes_j], **TOL)
    # a short tail is padded by repeating its last sample
    imgs, labels, paths, _, n = got[-1]
    assert n < 4 or shard == (1, 3, True)
    assert all(p == paths[n - 1] for p in paths[n:])
    np.testing.assert_array_equal(imgs[n:], np.broadcast_to(imgs[n - 1], imgs[n:].shape))


def test_dataloader_raises_worker_errors(synth_set, tmp_path):
    bad = tmp_path / "images" / "val"
    bad.mkdir(parents=True)
    for name in sorted(os.listdir(synth_set["val"]))[:3]:
        os.symlink(os.path.join(synth_set["val"], name), bad / name)
    loader, dataset = create_dataloader(str(bad), EVAL_IMG_SIZE, 2, task="val")
    # a file that turns into a JPEG after the scan cached its header
    with open(dataset.img_paths[2], "rb") as f:
        head = f.read()
    os.unlink(dataset.img_paths[2])
    with open(dataset.img_paths[2], "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + head[4:])
    with pytest.raises(ValueError, match="JPEG"):
        list(loader)
    # the train-mode loader (augmenting, shuffled) raises it in the consumer too
    hyp = dict(mosaic=0.0, degrees=0.0, translate=0.1, scale=0.5, shear=0.0)
    train_loader, _ = create_dataloader(str(bad), EVAL_IMG_SIZE, 3, hyp=hyp, augment=True,
                                        task="train")
    with pytest.raises(ValueError, match="JPEG"):
        list(train_loader)


def test_synth_generator_matches_jax_labels(tmp_path):
    """Square images and one seed: the same label rows as the JAX generator's."""
    ours = generate_synth_dataset(str(tmp_path / "a"), n_train=3, n_val=2, img_size=96, seed=7)
    theirs = jax_generate_synth_dataset(str(tmp_path / "b"), n_train=3, n_val=2, img_size=96,
                                        seed=7)
    for split in ("train", "val"):
        names = sorted(os.listdir(tmp_path / "b" / "labels" / split))
        assert sorted(os.listdir(tmp_path / "a" / "labels" / split)) == names
        for name in names:
            assert ((tmp_path / "a" / "labels" / split / name).read_text()
                    == (tmp_path / "b" / "labels" / split / name).read_text())
    data = load_data_config(ours)
    with open(theirs) as f:
        data_j = yaml.safe_load(f)
    assert {k: v for k, v in data.items() if k not in ("train", "val")} == \
        {k: v for k, v in data_j.items() if k not in ("train", "val")}
    img = imread(os.path.join(data["val"], "val00000.png"))
    assert img.shape == (96, 96, 3)


@pytest.mark.parametrize("name", ["coco.yaml", "dataset.yaml", "voc.yaml"])
def test_load_data_config_matches_yaml(name):
    path = os.path.join(REPO_ROOT, "data", name)
    with open(path) as f:
        assert load_data_config(path) == yaml.safe_load(f)


def test_load_data_config_refuses_what_it_does_not_read(tmp_path):
    cases = {"nested.yaml": "a:\n  b: 1\n", "block.yaml": "names:\n  - x\n",
             "anchor.yaml": "a: &x 1\n", "open.yaml": "names: [a, b\n", "x.txt": "a: 1\n"}
    for name, text in cases.items():
        (tmp_path / name).write_text(text)
        with pytest.raises(ValueError):
            load_data_config(str(tmp_path / name))
    (tmp_path / "ok.yaml").write_text("a: 'x # y' # c\nb: [1, 2.5, no, ~, \"q\"]\nc:\n")
    assert load_data_config(str(tmp_path / "ok.yaml")) == yaml.safe_load(
        (tmp_path / "ok.yaml").read_text())
