"""One epoch of the port's ``Trainer`` (yolov6_tpu_torch/core/engine.py)
against the JAX package's ``Trainer`` (yolov6_tpu/core/engine.py) on the CPU:
small N (configs/yolov6n.py at depth 0.1, width 0.0625; SIoU), 8 PNG images
at 128 px, batch 4, so one epoch is 2 steps, the augmentation off (every
gain 0: the letterbox + identity-affine branch, no HSV, no flips) and the
same shuffle (seed 0), from the JAX trainer's initial weights
(``state_dict_from_jax``). A file of its own, so that its JAX compile runs on
a worker of its own.

Tolerance, PR 3's whole-step test's (tests/test_torch_train_step.py): the
epoch's mean loss components within rtol 1e-4 / atol 1e-6; every parameter's
change over the epoch within 1e-3 of the JAX change's largest magnitude plus
1e-7; every EMA leaf and BN statistic within 1e-4 of the JAX leaf's largest
magnitude plus 1e-6; the step counters equal.

Both trainers log to TensorBoard (the JAX one through torch's
``SummaryWriter``) with ``--write_trainbatch_tb``: their event files hold
``train_batch`` at step 1, equal outside the text (tests/
test_torch_train_plots.py), and the epoch-end scalars, computed from each
trainer's own state as the JAX trainer computes them (engine.py:524-536):
the losses within the loss tolerance above, the APs and LRs equal.
"""

import glob
import importlib.util
import os.path as osp
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.core.engine import Trainer as JaxTrainer
from yolov6_tpu.parallel.mesh import create_mesh
from yolov6_tpu.solver.build import group_lrs_host as jax_group_lrs_host
from yolov6_tpu.utils.events import write_tblog as jax_write_tblog
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.core.engine import Trainer
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.tools import train as train_cli
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.tb_writer import read_events
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_train_plots import TextCalls
from torch_port_utils import REPO_ROOT, small_n_config

IMG = 128
NO_AUG = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, degrees=0.0, translate=0.0, scale=0.0,
              shear=0.0, flipud=0.0, fliplr=0.0, mosaic=0.0, mixup=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's CPU training: with torch's default of
    a thread a core, the suite's parallel workers oversubscribe the host and
    these runs slow by tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_train_cli():
    spec = importlib.util.spec_from_file_location(
        "_jax_train_cli", osp.join(REPO_ROOT, "tools", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(config_cls):
    cfg = small_n_config(config_cls)
    cfg.training_mode = "repvgg"
    cfg.data_aug.update(NO_AUG)
    assert cfg.model.head.iou_type == "siou"
    return cfg


def _leaves(collections):
    return {k: v.numpy() for k, v in state_dict_from_jax(collections).items()
            if not k.endswith("num_batches_tracked")}


def _close(got, want, name):
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()) + 1e-6, (name, err)


def _close_delta(got, want, name):
    """max |Δport − Δjax| ≤ 1e-3·max|Δjax| + 1e-7."""
    err = float(np.abs(got - want).max())
    assert err <= 1e-3 * float(np.abs(want).max()) + 1e-7, (name, err, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """Both trainers after epoch 0, and the parameters both started from. To fit the file's time on one CPU core
    (the JAX side: about 30 s of op-by-op ``model.init`` and 130 s of step
    compile, cold), the JAX trainer runs on a one-device mesh and its step
    compiles with XLA's optimizations off (``jax_disable_most_optimizations``,
    restored after)."""
    root = tmp_path_factory.mktemp("trainer_jax")
    data = generate_synth_dataset(str(root / "set"), n_train=8, n_val=4, img_size=IMG, nc=3,
                                  seed=2)
    argv = ["--data-path", data, "--img-size", str(IMG), "--batch-size", "4", "--epochs", "3",
            "--workers", "2", "--max-labels", "8", "--seed", "0", "--log-interval", "1",
            "--write_trainbatch_tb"]
    jargs = _jax_train_cli().get_args_parser().parse_args(argv)
    jargs.save_dir = str(root / "jax")
    optimizations = jax.config.values["jax_disable_most_optimizations"]
    # torch's SummaryWriter imports TensorFlow when it is installed (about 15
    # s); without it, its own stubs
    no_tf = "tensorflow" not in sys.modules
    if no_tf:
        sys.modules["tensorflow"] = None
    patch = pytest.MonkeyPatch()
    calls = TextCalls(patch)
    try:
        jax.config.update("jax_disable_most_optimizations", True)
        theirs = JaxTrainer(jargs, _cfg(JaxConfig), mesh=create_mesh(1))
        args = train_cli.get_args_parser().parse_args(argv + ["--device", "cpu"])
        args.save_dir = str(root / "port")
        ours = Trainer(args, _cfg(Config))
        variables = {"params": jax.device_get(theirs.state.params),
                     "batch_stats": jax.device_get(theirs.state.batch_stats)}
        sd = state_dict_from_jax(variables)
        params0 = _leaves({"params": variables["params"]})
        ours.train_step.model.load_state_dict(sd, strict=True)
        ours.train_step.ema.load_state_dict(sd, strict=True)
        for trainer in (theirs, ours):
            trainer.epoch = 0
            trainer.before_epoch()
            trainer.train_one_epoch(0)
        for trainer in (theirs, ours):
            trainer.tblogger.flush()
    finally:
        jax.config.update("jax_disable_most_optimizations", optimizations)
        patch.undo()
        if no_tf:
            del sys.modules["tensorflow"]
    theirs.text_calls = calls
    return theirs, ours, params0


def _events(save_dir):
    (path,) = glob.glob(osp.join(save_dir, "events.out.tfevents.*"))
    return read_events(path)


def test_tensorboard_logs_match_jax_trainer(trainers):
    theirs, ours, _ = trainers
    batches = []
    for trainer in (theirs, ours):
        imgs = {(t, e["step"]): v for e in _events(trainer.save_dir)
                for t, v in e.get("images", {}).items()}
        assert list(imgs) == [("train_batch", 1)]
        png = np.frombuffer(imgs["train_batch", 1]["png"], np.uint8)
        batches.append(cv2.imdecode(png, cv2.IMREAD_COLOR))
    got, want = batches[1], batches[0]
    assert got.shape == want.shape == (2 * IMG, 2 * IMG, 3)
    mask = theirs.text_calls.mask(got.shape[:2])
    assert mask.mean() < 0.5
    np.testing.assert_array_equal(got[~mask], want[~mask])

    # the epoch-end scalars, as JAX's engine.py:524-536 computes them
    lrs = jax_group_lrs_host(theirs.max_stepnum, 0.0, theirs.warmup_stepnum, theirs.solver_cfg,
                             theirs.max_epoch)
    jax_write_tblog(theirs.tblogger, 0, theirs.evaluate_results, list(lrs),
                    list(theirs.mean_loss[:3]))
    theirs.tblogger.flush()
    ours.log_epoch_scalars()
    scalars = [{t: (e["step"], v) for e in _events(trainer.save_dir)
                for t, v in e.get("scalars", {}).items()} for trainer in (theirs, ours)]
    assert sorted(scalars[0]) == sorted(scalars[1]) and len(scalars[0]) == 8
    for tag, (step, want) in scalars[0].items():
        step_p, got = scalars[1][tag]
        assert step_p == step == 1, tag
        if tag.startswith("train/"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=tag)
        else:
            assert got == want, tag


def test_one_epoch_matches_jax_trainer(trainers):
    theirs, ours, params0 = trainers
    assert ours.max_stepnum == theirs.max_stepnum == 2
    assert ours.warmup_stepnum == theirs.warmup_stepnum == 1000
    assert ours.solver_cfg == dict(theirs.solver_cfg)
    st = theirs.state
    step = ours.train_step
    assert int(step.step) == int(st.step) == 2
    assert int(step.ema_updates) == int(st.ema_updates) > 0
    assert int(step.accum_count) == int(st.accum_count)
    np.testing.assert_allclose(ours.mean_loss, theirs.mean_loss, rtol=1e-4, atol=1e-6)
    assert ours.epoch_stats[0]["steps"] == 2

    params_j = _leaves({"params": jax.device_get(st.params)})
    sd = step.model.state_dict()
    for name, p in step.model.named_parameters():
        _close_delta(p.detach().numpy() - params0[name], params_j[name] - params0[name],
                     f"param {name}")
    for name, want in _leaves({"batch_stats": jax.device_get(st.batch_stats)}).items():
        _close(sd[name].numpy(), want, f"bn {name}")
    ema = step.ema.state_dict()
    ema_j = _leaves({"params": jax.device_get(st.ema_params),
                     "batch_stats": jax.device_get(st.ema_batch_stats)})
    assert set(ema_j) == {k for k in ema if not k.endswith("num_batches_tracked")}
    for name, want in ema_j.items():
        _close(ema[name].numpy(), want, f"ema {name}")


def test_same_batches_as_jax(trainers):
    """The two loaders give the same pixels and labels in the same order."""
    theirs, ours, _ = trainers
    for (imgs, labels, paths, *_), (imgs_j, labels_j, paths_j, *_) in zip(
            ours.train_loader, theirs.train_loader):
        np.testing.assert_array_equal(np.asarray(imgs), imgs_j)
        np.testing.assert_array_equal(labels, labels_j)
        assert paths == paths_j
