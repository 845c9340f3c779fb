"""The port's trainer (yolov6_tpu_torch/core/engine.py, tools/train.py) end to
end on the CPU: the counterpart of tests/test_train_cli.py, on 8 PNG images
at 64 px with configs/yolov6n.py at full width.

- 3 epochs with evals, checkpoints and the strong-augmentation shut-off;
- ``--resume``, the run's saved ``args.yaml`` winning over the command line;
- 2 epochs straight equal 1 epoch then a resume for the second, bit for bit,
  on every buffer of the step (parameters, BN statistics, momentum, EMA,
  counters) and on the EMA's state dict;
- the training recipes: ``--fuse_ab`` for one epoch with the DFL config (the
  distill recipe's teacher), then ``--distill --teacher_model_path`` against
  its ``best_ckpt.pt``, whose stripped checkpoint ``tools/eval.py`` loads with
  the original config; what still raises.
"""

import os
import os.path as osp
import shutil

import pytest
import torch

from yolov6_tpu_torch.core.engine import Trainer
from yolov6_tpu_torch.tools import train as train_cli
from yolov6_tpu_torch.utils.checkpoint import load_checkpoint, load_state_dict_file
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.events import load_yaml

from torch_port_utils import REPO_ROOT

N_CONFIG = osp.join(REPO_ROOT, "configs", "yolov6n.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's CPU training: with torch's default of
    a thread a core, the suite's parallel workers oversubscribe the host and
    these runs slow by tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset

    root = tmp_path_factory.mktemp("tiny_train")
    return generate_synth_dataset(str(root), n_train=8, n_val=4, img_size=64, nc=3, seed=0,
                                  sizes=[(64, 64), (80, 60), (48, 64)])


def _args(data, out, *extra):
    return train_cli.get_args_parser().parse_args([
        "--data-path", data, "--conf-file", N_CONFIG, "--img-size", "64", "--img-floor", "64",
        "--batch-size", "4", "--workers", "2", "--heavy-eval-range", "0", "--output-dir", out,
        "--name", "run", "--max-labels", "8", "--log-interval", "1", "--seed", "0",
        "--device", "cpu", *extra])


def test_train_cli_end_to_end(tiny_set, tmp_path):
    args = _args(tiny_set, str(tmp_path), "--epochs", "3", "--eval-interval", "2",
                 "--stop_aug_last_n_epoch", "1", "--save_ckpt_on_last_n_epoch", "2")
    trainer = train_cli.main(args)
    weights = osp.join(args.save_dir, "weights")
    assert sorted(os.listdir(weights)) == ["1_ckpt.pt", "2_ckpt.pt", "best_ckpt.pt",
                                           "last_ckpt.pt"]
    # evals after epoch 1 (interval 2) and the final epoch 2
    assert [e["epoch"] for e in trainer.eval_stats] == [1, 2]
    assert all(e["images"] == 4 for e in trainer.eval_stats)
    assert [e["epoch"] for e in trainer.epoch_stats] == [0, 1, 2]
    assert all(e["steps"] == 2 and all(v == v for v in e["mean_loss"])
               for e in trainer.epoch_stats)
    # the shut-off before the last epoch: mosaic and mixup off, loaders rebuilt
    assert trainer.cfg.data_aug.mosaic == 0 and trainer.train_loader.dataset.hyp["mosaic"] == 0
    # the final checkpoints are stripped to the EMA, which the deploy graph loads
    last = load_checkpoint(osp.join(weights, "last_ckpt.pt"))
    assert sorted(last) == ["epoch", "model"] and last["epoch"] == 2
    ema = trainer.train_step.ema.state_dict()
    assert all(torch.equal(last["model"][k], ema[k]) for k in ema)
    model = load_state_dict_file(osp.join(weights, "last_ckpt.pt"), Config.fromfile(N_CONFIG),
                                 device="cpu")
    assert model.num_classes == 3 and not model.training
    full = load_checkpoint(osp.join(weights, "1_ckpt.pt"))
    assert sorted(full) == ["ema", "epoch", "model", "results", "train_state"]
    assert full["epoch"] == 1 and len(full["results"]) == 2
    assert load_yaml(osp.join(args.save_dir, "args.yaml"))["epochs"] == 3


def test_resume_takes_the_saved_args(tiny_set, tmp_path):
    args = _args(tiny_set, str(tmp_path), "--epochs", "2", "--eval-final-only",
                 "--stop_aug_last_n_epoch", "1", "--save_ckpt_on_last_n_epoch", "2")
    train_cli.main(args)
    ckpt = osp.join(args.save_dir, "weights", "0_ckpt.pt")
    rargs = train_cli.get_args_parser().parse_args(
        ["--resume", ckpt, "--epochs", "9", "--batch-size", "2", "--device", "cpu"])
    cfg = train_cli.check_and_init(rargs)
    assert rargs.epochs == 2 and rargs.batch_size == 4 and rargs.resume == ckpt
    assert rargs.save_dir == args.save_dir and rargs.img_size == 64
    trainer = Trainer(rargs, cfg)
    assert trainer.start_epoch == 1
    # the resumed epoch is the first of the shut-off tail: mosaic until its start
    assert cfg.data_aug.mosaic == 1.0
    trainer.epoch = trainer.start_epoch
    trainer.before_epoch()
    assert trainer.train_loader.dataset.hyp["mosaic"] == 0.0
    # the finished run's last_ckpt.pt is stripped: no train state to resume
    stripped = train_cli.get_args_parser().parse_args(
        ["--resume", osp.join(args.save_dir, "weights", "last_ckpt.pt"), "--device", "cpu"])
    with pytest.raises(ValueError, match="no train state"):
        Trainer(stripped, train_cli.check_and_init(stripped))


def test_resume_continues_bit_for_bit(tiny_set, tmp_path):
    """2 epochs straight == 1 epoch, then ``--resume`` from the epoch-0
    checkpoint for the second (in a copy of the run's directory)."""
    args = _args(tiny_set, str(tmp_path / "a"), "--epochs", "2", "--eval-final-only",
                 "--stop_aug_last_n_epoch", "1", "--save_ckpt_on_last_n_epoch", "2")
    straight = train_cli.main(args)
    copy = str(tmp_path / "b")
    shutil.copytree(args.save_dir, copy)
    os.remove(osp.join(copy, "weights", "1_ckpt.pt"))
    rargs = train_cli.get_args_parser().parse_args(
        ["--resume", osp.join(copy, "weights", "0_ckpt.pt"), "--device", "cpu"])
    resumed = train_cli.main(rargs)
    assert resumed.start_epoch == 1 and [e["epoch"] for e in resumed.epoch_stats] == [1]
    assert resumed.epoch_stats[0]["mean_loss"] == straight.epoch_stats[1]["mean_loss"]
    want, got = straight.train_step.state_dict(), resumed.train_step.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    ema_w, ema_g = straight.train_step.ema.state_dict(), resumed.train_step.ema.state_dict()
    assert all(torch.equal(ema_g[k], ema_w[k]) for k in ema_w)
    saved = load_checkpoint(osp.join(copy, "weights", "1_ckpt.pt"))["train_state"]
    assert all(torch.equal(saved[k], want[k]) for k in want)
    assert straight.evaluate_results == resumed.evaluate_results


@pytest.mark.parametrize("flag,item", [("--ckpt-backend=orbax", "Do not port"),
                                       ("--cache=ram", "The rest of the trainer"),
                                       ("--write_trainbatch_tb", "The rest of the trainer")])
def test_unported_options_raise(tiny_set, tmp_path, flag, item):
    """Each refusal names its ROADMAP queue item by its title."""
    args = _args(tiny_set, str(tmp_path), "--epochs", "1", flag)
    with pytest.raises(NotImplementedError, match=item):
        train_cli.main(args)
    assert not os.path.exists(osp.join(str(tmp_path), "run"))


def test_more_than_one_process_raises(tiny_set, tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="Parallelism"):
        train_cli.main(_args(tiny_set, str(tmp_path), "--epochs", "1"))


def test_trainer_needs_a_device_without_cuda(tiny_set, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(tiny_set, str(tmp_path), "--epochs", "1")
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(args)


# ------------------------------------------------------- the training recipes


@pytest.fixture(scope="module")
def dfl_config(tmp_path_factory):
    """configs/yolov6n.py with DFL switched on, as the distill recipe trains
    both its stages."""
    path = tmp_path_factory.mktemp("conf") / "yolov6n_dfl.py"
    with open(N_CONFIG) as f:
        path.write_text(f.read().replace("use_dfl=False", "use_dfl=True")
                        .replace("reg_max=0", "reg_max=16"))
    return str(path)


@pytest.fixture(scope="module")
def fuse_ab_run(tiny_set, dfl_config, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fuse_ab"))
    args = _args(tiny_set, out, "--epochs", "1", "--fuse_ab")
    args.conf_file = dfl_config
    return args, train_cli.main(args)


def test_fuse_ab_cli_one_epoch(fuse_ab_run, dfl_config):
    """Anchor-aided training: the fuse-AB head's anchor-based branch trains
    beside the anchor-free one (its loss adds to the components) and is
    dropped at the fold."""
    args, trainer = fuse_ab_run
    assert type(trainer.model.detect).__name__ == "DetectFuseAB"
    assert trainer.compute_loss_ab is not None and trainer.train_step.compute_loss_ab is not None
    stats = trainer.epoch_stats
    assert len(stats) == 1 and stats[0]["steps"] == 2 and len(stats[0]["mean_loss"]) == 3
    assert all(v == v and v >= 0 for v in stats[0]["mean_loss"])
    assert [e["epoch"] for e in trainer.eval_stats] == [0]
    best = osp.join(args.save_dir, "weights", "best_ckpt.pt")
    state = load_checkpoint(best)["model"]
    assert any(k.startswith("detect.cls_preds_ab.") for k in state)
    model = load_state_dict_file(best, Config.fromfile(dfl_config), device="cpu")
    assert not any("_ab." in k for k in model.state_dict())


def test_distill_cli_against_the_fuse_ab_teacher(fuse_ab_run, tiny_set, dfl_config, tmp_path):
    """Self-distillation of N against the fuse-AB run's best checkpoint: the
    distill-NS head, the four components, a teacher that does not move, and
    a stripped checkpoint that tools/eval.py loads with the original config
    (no DFL): the fold drops the train-only DFL branch."""
    from yolov6_tpu_torch.tools.eval import run as eval_run

    t_args, _ = fuse_ab_run
    teacher_ckpt = osp.join(t_args.save_dir, "weights", "best_ckpt.pt")
    args = _args(tiny_set, str(tmp_path), "--epochs", "1", "--distill", "--distill_feat",
                 "--teacher_model_path", teacher_ckpt, "--temperature", "10")
    args.conf_file = dfl_config
    trainer = train_cli.main(args)
    assert trainer.distill_ns and type(trainer.model.detect).__name__ == "DetectDistillNS"
    assert type(trainer.teacher.detect).__name__ == "DetectFuseAB" and not trainer.teacher.training
    loss = trainer.train_step.compute_loss
    assert type(loss).__name__ == "ComputeLossDistillNS"
    assert (loss.temperature, loss.distill_feat, loss.max_epoch) == (10, True, 1)
    teacher_state = load_checkpoint(teacher_ckpt)["model"]
    for key, value in trainer.teacher.state_dict().items():
        assert torch.equal(value, teacher_state[key]), key
    # a teacher trained without --fuse_ab lacks only the anchor-based branch,
    # which the JAX partial load leaves at its init: tolerated
    plain = str(tmp_path / "plain_teacher.pt")
    torch.save({"model": {k: v for k, v in teacher_state.items() if "_ab." not in k}}, plain)
    partial = trainer.load_teacher(plain)
    assert torch.equal(partial.detect.reg_preds_ab[0].bias, torch.ones(12))
    mean = trainer.epoch_stats[0]["mean_loss"]
    assert len(mean) == 4 and all(v == v for v in mean) and mean[3] > 0
    last = osp.join(args.save_dir, "weights", "last_ckpt.pt")
    assert any(k.startswith("detect.reg_preds_dist.") for k in load_checkpoint(last)["model"])
    (ap50, ap), _ = eval_run(tiny_set, weights=last, config=N_CONFIG, batch_size=4, img_size=64,
                             half=False, save_dir=str(tmp_path / "eval"), device="cpu")
    assert 0.0 <= ap50 <= 1.0 and 0.0 <= ap <= 1.0


def test_distill_refuses_fuse_ab_and_a_missing_teacher(tiny_set, tmp_path, fuse_ab_run):
    t_args, _ = fuse_ab_run
    teacher_ckpt = osp.join(t_args.save_dir, "weights", "best_ckpt.pt")
    with pytest.raises(ValueError, match="fuse_ab"):
        train_cli.main(_args(tiny_set, str(tmp_path), "--epochs", "1", "--fuse_ab", "--distill",
                             "--teacher_model_path", teacher_ckpt))
    with pytest.raises(ValueError, match="teacher_model_path"):
        train_cli.main(_args(tiny_set, str(tmp_path), "--epochs", "1", "--distill"))
    assert not os.path.exists(osp.join(str(tmp_path), "run"))


def test_distill_teacher_must_fit(tiny_set, tmp_path, fuse_ab_run):
    """A teacher checkpoint of another graph (here the DFL run's, for the
    config without DFL) raises instead of training against a half-loaded
    teacher."""
    t_args, _ = fuse_ab_run
    teacher_ckpt = osp.join(t_args.save_dir, "weights", "best_ckpt.pt")
    args = _args(tiny_set, str(tmp_path), "--epochs", "1", "--distill",
                 "--teacher_model_path", teacher_ckpt)
    with pytest.raises(ValueError, match="does not fit the teacher"):
        train_cli.main(args)


def test_repopt_config_and_the_gate_repopt_raise(tiny_set, tmp_path):
    """What RepOpt still refuses: an opt config whose scales are its default
    JAX msgpack file (the error names the formats the port reads),
    ``--quant`` on an ``_opt_qat`` config whose ``pretrained`` is its
    default JAX file, which is absent (the port downloads nothing; QAT
    itself is tests/test_torch_trainer_qat.py's), and the gate's ``--repopt``
    beside another gate mode."""
    from yolov6_tpu_torch.tools import learning_gate

    args = _args(tiny_set, str(tmp_path), "--epochs", "1")
    args.conf_file = osp.join(REPO_ROOT, "configs", "repopt", "yolov6n_opt.py")
    with pytest.raises(ValueError, match="msgpack.*last_ckpt.pt"):
        train_cli.main(args)
    args = _args(tiny_set, str(tmp_path), "--epochs", "1", "--quant")
    args.conf_file = osp.join(REPO_ROOT, "configs", "repopt", "yolov6n_opt_qat.py")
    with pytest.raises(FileNotFoundError, match="yolov6n_opt.msgpack not found"):
        train_cli.main(args)
    gate_args = learning_gate.get_args_parser().parse_args(
        ["--out", str(tmp_path / "gate"), "--repopt", "--fuse-ab", "--device", "cpu"])
    with pytest.raises(ValueError, match="pick one"):
        learning_gate.main(gate_args)


def test_repopt_gate_runs_both_stages(tmp_path):
    """``learning_gate --repopt`` at a tiny size (N at 64 px, 8 train and 4
    val images, 1 hyper-search epoch, 2 RepOpt epochs; no bar): the hs stage
    writes its last_ckpt.pt, the generated opt config points its scales at
    it, the RepOpt stage trains the RealVGG graph with the masks and its
    checkpoints evaluate with that config."""
    import json

    from yolov6_tpu_torch.layers.common import LinearAddBlock, RealVGGBlock
    from yolov6_tpu_torch.tools import learning_gate

    args = learning_gate.get_args_parser().parse_args([
        "--out", str(tmp_path), "--repopt", "--img-size", "64", "--n-train", "8", "--n-val",
        "4", "--epochs", "2", "--hs-epochs", "1", "--batch-size", "4", "--workers", "1",
        "--eval-points", "2", "--skip-exact-nms", "--device", "cpu"])
    learning_gate.main(args)
    with open(osp.join(str(tmp_path), "gate_result.json")) as f:
        result = json.load(f)
    assert result["mode"] == "repopt" and len(result["trajectory"]) == 2
    hs = result["hyper_search"]
    assert [e["epoch"] for e in hs["epoch_stats"]] == [0] and hs["final_map50"] is not None
    scales_ckpt = osp.join(str(tmp_path), "train_hs", "hs", "weights", "last_ckpt.pt")
    with open(hs["conf"]) as f:
        assert f"scales={scales_ckpt!r}" in f.read()
    cfg = Config.fromfile(hs["conf"])
    assert cfg.training_mode == "repopt" and cfg.model.scales == scales_ckpt
    hs_state = load_checkpoint(scales_ckpt)["model"]
    assert any(k.endswith("scale_conv.weight") for k in hs_state)
    assert all(len(e["mean_loss"]) == 3 for e in result["epoch_stats"])
    targs = _args(osp.join(str(tmp_path), "dataset", "data.json"), str(tmp_path / "b"),
                  "--epochs", "1")
    targs.conf_file = hs["conf"]
    trainer = Trainer(targs, train_cli.check_and_init(targs))
    blocks = [m for m in trainer.model.modules() if isinstance(m, RealVGGBlock)]
    assert blocks and not any(isinstance(m, LinearAddBlock) for m in trainer.model.modules())
    assert trainer.train_step._mask is not None
    assert len(trainer.repopt_scales) == len(blocks)
