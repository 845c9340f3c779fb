"""The port's trainer on a P6 config on the CPU: small M6 (configs/yolov6m6.py
at depth 0.1, width 0.125) through tools/train.py at 128 px, so that stride
64 has a 2x2 grid, on 8 PNG images.

- one epoch, on the ATSS branch (P6's ``atss_warmup_epoch`` is 4) through
  the mosaic/affine C++ pass, with an in-training eval of the four levels,
  a checkpoint and the DFL loss;
- ``--distill`` against that run's best checkpoint: the teacher is the
  plain train graph (``Detect``), not the fuse-AB one, which a P6 config
  cannot build (it sets no ``anchors_init``), as the JAX trainer builds it
  (yolov6_tpu/core/engine.py:110); the student trains with the M/L
  distillation loss (``ComputeLossDistill``) and takes its steps.
"""

import os.path as osp

import pytest
import torch

from yolov6_tpu_torch.tools import train as train_cli
from yolov6_tpu_torch.utils.checkpoint import load_checkpoint

from torch_port_utils import P6_CONFIGS

IMG = 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as tests/test_torch_trainer.py runs its training."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_m6(tmp_path_factory):
    """The set, and configs/yolov6m6.py cut to depth 0.1 and width 0.125."""
    from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset

    root = tmp_path_factory.mktemp("p6_train")
    data = generate_synth_dataset(str(root / "set"), n_train=8, n_val=4, img_size=IMG, nc=3,
                                  seed=0, sizes=[(128, 128), (160, 120), (96, 128)])
    conf = root / "yolov6m6_small.py"
    with open(P6_CONFIGS["m6"]) as f:
        conf.write_text(f.read() + "\nmodel['depth_multiple'] = 0.1\n"
                        "model['width_multiple'] = 0.125\n")
    return data, str(conf), root


def _args(data, conf, out, *extra):
    return train_cli.get_args_parser().parse_args([
        "--data-path", data, "--conf-file", conf, "--img-size", str(IMG), "--img-floor",
        str(IMG), "--batch-size", "4", "--workers", "2", "--heavy-eval-range", "0",
        "--epochs", "1", "--output-dir", out, "--name", "run", "--max-labels", "8",
        "--log-interval", "1", "--seed", "0", "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def plain_run(small_m6):
    data, conf, root = small_m6
    args = _args(data, conf, str(root / "plain"))
    return args, train_cli.main(args)


def test_p6_trains_an_epoch_on_atss_and_evaluates(plain_run):
    args, trainer = plain_run
    assert trainer.model.strides == (8, 16, 32, 64)
    assert trainer.atss_warmup_epoch == 4 and trainer.compute_loss.use_dfl
    stats = trainer.epoch_stats
    assert len(stats) == 1 and stats[0]["steps"] == 2
    assert all(v == v and v >= 0 for v in stats[0]["mean_loss"]) and stats[0]["mean_loss"][1] > 0
    assert [e["epoch"] for e in trainer.eval_stats] == [0]
    assert trainer.eval_stats[0]["images"] == 4
    assert osp.exists(osp.join(args.save_dir, "weights", "best_ckpt.pt"))


def test_distill_on_p6_builds_a_plain_teacher_and_steps(plain_run, small_m6, tmp_path):
    t_args, _ = plain_run
    data, conf, _ = small_m6
    teacher_ckpt = osp.join(t_args.save_dir, "weights", "best_ckpt.pt")
    args = _args(data, conf, str(tmp_path), "--distill", "--distill_feat",
                 "--teacher_model_path", teacher_ckpt)
    trainer = train_cli.main(args)
    assert not trainer.distill_ns
    assert type(trainer.teacher.detect).__name__ == "Detect" and not trainer.teacher.training
    assert type(trainer.model.detect).__name__ == "Detect"
    assert type(trainer.train_step.compute_loss).__name__ == "ComputeLossDistill"
    teacher_state = load_checkpoint(teacher_ckpt)
    teacher_state = teacher_state.get("ema") or teacher_state["model"]
    for key, value in trainer.teacher.state_dict().items():
        assert torch.equal(value, teacher_state[key]), key
    stats = trainer.epoch_stats
    assert len(stats) == 1 and stats[0]["steps"] == 2
    mean = stats[0]["mean_loss"]
    assert len(mean) == 4 and all(v == v for v in mean) and mean[3] > 0
