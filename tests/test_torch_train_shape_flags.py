"""The train CLI's shape and check flags in the port (tools/train.py,
core/engine.py, data/datasets.py) against the JAX package, on the CPU.

- Train samples at ``--specific-shape --height 96 --width 160``: with the JAX
  package's ``random``/``np.random`` seeded as the port's per-sample
  ``Draws``, every mosaic (with and without mixup) and letterbox + affine
  sample equals the JAX native path's, image and labels, tolerance none; the
  scans under ``check_images``/``check_labels`` keep the same files.
- One step at 96x160 of the small N graph (depth 0.1, width 0.0625, SIoU)
  from the same variables, mid-schedule as in test_torch_train_step.py: the
  loss and components within rtol 1e-4 / atol 1e-6, each parameter's change
  and momentum within 1e-3 of the JAX leaf's largest magnitude plus that
  file's floors. JAX's ``make_train_step`` is called at (96, 160); its
  trainer builds the step at (img_size, img_size) whatever the shape, which
  the port does not copy (the anchors would not fit the batch).
- The parser takes a JAX command line with all eight flags, and the CLI
  trains one epoch at a specific shape with both checks on a set holding an
  unreadable file, a truncated JPEG and an out-of-range label file.
"""

import os
import os.path as osp
import random
import shutil

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.core.train_step import create_train_state
from yolov6_tpu.core.train_step import make_train_step as jax_make_train_step
from yolov6_tpu.data.datasets import TrainValDataset as JaxDataset
from yolov6_tpu.losses.loss import ComputeLoss as JaxComputeLoss
from yolov6_tpu.solver.build import build_param_groups

from yolov6_tpu_torch.data.data_augment import sample_seed
from yolov6_tpu_torch.data.datasets import TrainValDataset
from yolov6_tpu_torch.data.image_io import imread
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.solver.build import scale_hyperparams_for_batch
from yolov6_tpu_torch.tools import train as train_cli
from yolov6_tpu_torch.utils.data_config import load_data_config

from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_train_step import (
    EPOCHS, LOSS_KW, MID_EPOCH, MID_FLOOR, MID_LR, MID_STEP, S_SOLVER, _close_rel,
    _jax_leaves, _params, _train_variables,
)
from torch_image_fixtures import smooth_image
from torch_port_utils import N_CONFIG, small_n_config

H, W, SEED = 96, 160, 3
SIZES = [(96, 72), (80, 96), (120, 90), (50, 64), (64, 64), (33, 47)]


def _hyp(mosaic, mixup=0.0):
    return dict(mosaic=mosaic, mixup=mixup, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=5.0,
                translate=0.1, scale=0.5, shear=1.0, flipud=0.5, fliplr=0.5)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """10 PNG train images of mixed sizes, plus an unreadable ``.png``, a PNG
    whose pixels do not decode, and a label file out of range."""
    root = tmp_path_factory.mktemp("shape_data")
    data = load_data_config(generate_synth_dataset(
        str(root), n_train=10, n_val=0, img_size=64, nc=4, seed=5, sizes=SIZES))
    images, labels = data["train"], data["train"].replace("images", "labels")
    with open(osp.join(images, "zz_garbage.png"), "wb") as f:
        f.write(np.random.default_rng(1).integers(0, 256, 300, np.uint8).tobytes())
    first = sorted(os.listdir(images))[0]
    png = bytearray(open(osp.join(images, first), "rb").read())
    i = png.index(b"IDAT") + 12
    png[i] ^= 0xFF
    with open(osp.join(images, "zz_corrupt.png"), "wb") as f:
        f.write(bytes(png))
    for name in ("zz_garbage", "zz_corrupt"):
        shutil.copy(osp.join(labels, osp.splitext(first)[0] + ".txt"),
                    osp.join(labels, f"{name}.txt"))
    with open(osp.join(labels, osp.splitext(first)[0] + ".txt"), "a") as f:
        f.write("1 0.5 1.25 0.2 0.2\n")  # out of range: check_labels drops the file's rows
    return data


def _pair(data, hyp):
    kw = dict(img_size=64, batch_size=4, augment=True, hyp=hyp, task="train",
              data_dict=dict(data), specific_shape=True, height=H, width=W,
              check_images=True, check_labels=True)
    ours = TrainValDataset(data["train"], seed=SEED, **kw)
    theirs = JaxDataset(data["train"], **kw)
    assert theirs._native_aug
    return ours, theirs


def test_checked_scans_keep_the_same_files(data):
    ours, theirs = _pair(data, _hyp(1.0))
    assert ours.img_paths == theirs.img_paths and len(ours) == 10
    assert not any("zz_" in p for p in ours.img_paths)
    np.testing.assert_array_equal(ours.shapes, theirs.shapes)
    for a, b in zip(ours.labels, theirs.labels):
        np.testing.assert_array_equal(a, b)
    assert len(ours.labels[0]) == 0  # the out-of-range file's rows are dropped
    plain = TrainValDataset(data["train"], img_size=64, augment=False)
    assert len(plain) == 12  # without the checks nothing is dropped


@pytest.mark.parametrize("mosaic,mixup", [(1.0, 0.0), (1.0, 1.0), (0.0, 0.0)],
                         ids=["mosaic", "mosaic_mixup", "letterbox_affine"])
def test_specific_shape_samples_equal_jax(data, mosaic, mixup):
    ours, theirs = _pair(data, _hyp(mosaic, mixup))
    for epoch in (0, 1):
        ours.epoch = epoch
        for index in range(len(ours)):
            seed = sample_seed(SEED, epoch, index)
            random.seed(seed)
            np.random.seed(seed)
            img_j, labels_j, path_j, shapes_j = theirs[index]
            img, labels, path, shapes = ours[index]
            assert img.shape == (H, W, 3) and img.dtype == np.uint8
            np.testing.assert_array_equal(img, img_j)
            np.testing.assert_array_equal(labels, labels_j)
            assert path == path_j and shapes == shapes_j


def test_ram_cache_at_a_specific_shape_is_the_uncached_sample(data):
    ours, _ = _pair(data, _hyp(1.0, 0.5))
    cached = TrainValDataset(data["train"], img_size=64, batch_size=4, augment=True,
                             hyp=_hyp(1.0, 0.5), specific_shape=True, height=H, width=W,
                             check_images=True, seed=SEED, cache="ram")
    for index in range(4):
        a, b = ours[index], cached[index]
        np.testing.assert_array_equal(a[0], b[0])
    im, (h0, w0), (h, w) = cached.load_image_rgb(0)
    assert h <= H and w <= W and (h == int(h0 * min(W / w0, H / h0)))


def test_non_square_step_matches_jax():
    """One mid-schedule step at 96x160 (b2) of the small N graph."""
    loss_kw = dict(LOSS_KW, iou_type="siou")
    jmodel, variables = _train_variables(71, make_cfg=small_n_config)
    solver = scale_hyperparams_for_batch(S_SOLVER, 64)
    jstep = jax_make_train_step(
        jmodel, JaxComputeLoss(**loss_kw), build_param_groups(variables["params"]), solver,
        max_stepnum=100, epochs=EPOCHS, batch_size=64, warmup_stepnum=0, img_size=(H, W))
    model = build_model(small_n_config(Config), num_classes=3, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    step = make_train_step(model, ComputeLoss(**loss_kw), solver, 100, EPOCHS, 64, 0, (H, W),
                           half=False, device="cpu")
    step.step.fill_(MID_STEP)
    jstate = create_train_state(variables)._replace(step=jnp.asarray(MID_STEP, jnp.int32))
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    targets = np.zeros((2, 8, 5), np.float32)
    targets[:, :, 0] = -1
    targets[0, :3] = [[0, 0.3, 0.35, 0.2, 0.5], [2, 0.7, 0.6, 0.15, 0.35], [1, 0.5, 0.5, 0.1, 0.2]]
    targets[1, :2] = [[1, 0.4, 0.6, 0.3, 0.5], [0, 0.8, 0.25, 0.12, 0.3]]
    before = _params(step)
    jstate, loss_j, comp_j = jstep(jstate, jnp.asarray(images), jnp.asarray(targets),
                                   jnp.asarray(MID_EPOCH), use_atss=False)
    loss_t, comp_t = step(images, targets, MID_EPOCH)
    assert float(loss_j) > 0
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(comp_t.numpy(), np.asarray(comp_j), rtol=1e-4, atol=1e-6)
    j_before = _jax_leaves({"params": variables["params"]})
    j_after = _jax_leaves({"params": jax.device_get(jstate.params)})
    j_momentum = _jax_leaves({"params": jax.device_get(jstate.opt.momentum_buf)})
    for name, p in step.model.named_parameters():
        ulp = float(np.spacing(np.abs(j_before[name]).max()))
        _close_rel((p.detach() - before[name]).numpy(), j_after[name] - j_before[name],
                   f"96x160 {name}", MID_FLOOR * MID_LR + 2 * ulp)
        _close_rel(step.momentum[name].numpy(), j_momentum[name], f"96x160 momentum {name}",
                   MID_FLOOR)


JAX_FLAGS = ["--specific-shape", "--height", "96", "--width", "160", "--check-images",
             "--check-labels", "--rect", "--dist_url", "tcp://127.0.0.1:1", "--gpu_count", "2"]


def test_parser_takes_the_jax_flags():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", osp.join(osp.dirname(N_CONFIG), "..", "tools", "train.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    ours = train_cli.get_args_parser().parse_args(JAX_FLAGS)
    theirs = jax_cli.get_args_parser().parse_args(JAX_FLAGS)
    for key in ("specific_shape", "height", "width", "check_images", "check_labels", "rect",
                "dist_url", "gpu_count"):
        assert getattr(ours, key) == getattr(theirs, key), key
    # every option string of the JAX CLI parses in the port's
    port_opts = {s for a in train_cli.get_args_parser()._actions for s in a.option_strings}
    jax_opts = {s for a in jax_cli.get_args_parser()._actions for s in a.option_strings}
    assert jax_opts <= port_opts, sorted(jax_opts - port_opts)


def test_check_and_init_rounds_the_shape(tmp_path):
    args = train_cli.get_args_parser().parse_args(
        JAX_FLAGS[:5] + ["--output-dir", str(tmp_path), "--conf-file", N_CONFIG,
                         "--device", "cpu", "--img-floor", "32", "--height", "100"])
    train_cli.check_and_init(args)
    assert (args.height, args.width) == (128, 160)
    args = train_cli.get_args_parser().parse_args(
        ["--specific-shape", "--output-dir", str(tmp_path), "--conf-file", N_CONFIG])
    with pytest.raises(ValueError, match="--height and --width"):
        train_cli.check_and_init(args)


def test_cli_trains_at_a_specific_shape_with_both_checks(tmp_path):
    """One epoch of N (full width) at 64x96 on CPU: the unreadable file is
    dropped, the truncated JPEG restored in place, the out-of-range labels
    dropped; the steps take 64x96 batches, the eval stays square at 64 and
    the train batch's TensorBoard image is the 64x96 grid."""
    data_path = generate_synth_dataset(str(tmp_path / "set"), n_train=7, n_val=4, img_size=64,
                                       nc=3, seed=0, sizes=[(64, 64), (80, 60), (48, 64)])
    data = load_data_config(data_path)
    images, labels = data["train"], data["train"].replace("images", "labels")
    import cv2

    jpg = cv2.imencode(".jpg", smooth_image(60, 80, 2))[1].tobytes()
    with open(osp.join(images, "cut.jpg"), "wb") as f:
        f.write(jpg[:len(jpg) // 2])
    with open(osp.join(images, "bad.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + bytes(40))
    for stem, row in (("cut", "0 0.5 0.5 0.3 0.3\n"), ("bad", "0 0.5 0.5 0.3 0.3\n")):
        with open(osp.join(labels, f"{stem}.txt"), "w") as f:
            f.write(row)
    args = train_cli.get_args_parser().parse_args([
        "--data-path", data_path, "--conf-file", N_CONFIG, "--img-size", "64", "--img-floor",
        "32", "--batch-size", "4", "--workers", "2", "--epochs", "1", "--output-dir",
        str(tmp_path / "runs"), "--name", "shape", "--max-labels", "8", "--seed", "0",
        "--device", "cpu", "--write_trainbatch_tb", *JAX_FLAGS[:1], "--height", "64",
        "--width", "96", "--check-images", "--check-labels", "--rect"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = train_cli.main(args)
    finally:
        torch.set_num_threads(threads)
    ds = trainer.train_loader.dataset
    names = sorted(osp.basename(p) for p in ds.img_paths)
    assert "bad.png" not in names and "cut.jpg" in names and len(names) == 8
    with open(osp.join(images, "cut.jpg"), "rb") as f:
        assert f.read()[-2:] == b"\xff\xd9"  # restored
    assert imread(osp.join(images, "cut.jpg")).shape == (60, 80, 3)
    assert trainer.train_step.img_size == (64, 96)
    batch = next(iter(trainer.train_loader))
    assert batch[0].shape[1:] == (64, 96, 3)
    grid = trainer.plot_train_batch(batch[0], batch[1], batch[2])
    assert grid.shape == (2 * 64, 2 * 96, 3)
    assert trainer.epoch_stats[0]["steps"] == 2
    assert trainer.eval_stats[-1]["images"] == 4
    assert trainer.val_loader.dataset.img_size == 64 and not trainer.val_loader.dataset.augment
