"""YOLOv6Lite-S through the port's CLIs on the CPU: ``tools/train.py`` at 128
px (so that stride 64 has a 2x2 grid) on 8 PNG images for one epoch, then
``tools/eval.py`` and ``tools/infer.py`` on the run's checkpoint.

- the train CLI takes the lite solver from the config (lr0 0.4, momentum
  0.9, weight decay 4e-5), trains on the ATSS branch (``atss_warmup_epoch``
  4) with SIoU and no DFL over four levels, evaluates in training and
  writes its checkpoints; ``--distill`` and ``--fuse_ab`` raise
  ``ValueError`` on a lite config, which has neither recipe;
- the eval CLI reads the stripped checkpoint (the EMA in its train form,
  folded into the deploy graph) and writes its predictions;
- the infer CLI draws and labels the repository's demo JPEGs at 128.
"""

import os
import os.path as osp

import pytest
import torch

from yolov6_tpu_torch.tools import eval as eval_cli
from yolov6_tpu_torch.tools import infer as infer_cli
from yolov6_tpu_torch.tools import train as train_cli

from test_torch_lite_model import LITE_CONFIGS
from torch_port_utils import REPO_ROOT

IMG = 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as tests/test_torch_trainer.py runs its training."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lite_run(tmp_path_factory):
    from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset

    root = tmp_path_factory.mktemp("lite_train")
    data = generate_synth_dataset(str(root / "set"), n_train=8, n_val=4, img_size=IMG, nc=3,
                                  seed=0, sizes=[(128, 128), (160, 120), (96, 128)])
    args = _args(data, str(root / "runs"))
    return data, args, train_cli.main(args)


def _args(data, out, *extra):
    return train_cli.get_args_parser().parse_args([
        "--data-path", data, "--conf-file", LITE_CONFIGS["s"], "--img-size", str(IMG),
        "--img-floor", str(IMG), "--batch-size", "4", "--workers", "2", "--heavy-eval-range",
        "0", "--epochs", "1", "--output-dir", out, "--name", "run", "--max-labels", "8",
        "--log-interval", "1", "--seed", "0", "--device", "cpu", *extra])


def test_lite_trains_an_epoch_on_atss_and_evaluates(lite_run):
    _, args, trainer = lite_run
    assert type(trainer.model.detect).__name__ == "DetectLite"
    assert trainer.model.strides == (8, 16, 32, 64)
    assert (trainer.solver_cfg["lr0"], trainer.solver_cfg["momentum"]) == (0.4, 0.9)
    assert trainer.atss_warmup_epoch == 4 and not trainer.compute_loss.use_dfl
    assert trainer.compute_loss.iou_type == "siou"
    stats = trainer.epoch_stats
    assert len(stats) == 1 and stats[0]["steps"] == 2
    assert all(v == v and v >= 0 for v in stats[0]["mean_loss"])
    assert [e["epoch"] for e in trainer.eval_stats] == [0]
    assert osp.exists(osp.join(args.save_dir, "weights", "best_ckpt.pt"))


@pytest.mark.parametrize("recipe", [["--fuse_ab"], ["--distill", "--teacher_model_path", "t.pt"]],
                         ids=["fuse_ab", "distill"])
def test_train_cli_refuses_recipes_on_lite(lite_run, tmp_path, recipe):
    data, _, _ = lite_run
    with pytest.raises(ValueError, match="lite family"):
        train_cli.main(_args(data, str(tmp_path), *recipe))


def test_eval_and_infer_cli_on_the_lite_checkpoint(lite_run, tmp_path):
    data, args, _ = lite_run
    weights = osp.join(args.save_dir, "weights", "best_ckpt.pt")
    eval_args = eval_cli.get_args_parser().parse_args([
        "--data", data, "--config", LITE_CONFIGS["s"], "--weights", weights, "--device", "cpu",
        "--batch-size", "4", "--img-size", str(IMG), "--save_dir", str(tmp_path / "eval"),
        "--conf-thres", "0.001"])
    eval_cli.main(eval_args)
    assert (tmp_path / "eval" / "exp" / "predictions.json").stat().st_size > 2
    out = tmp_path / "infer"
    infer_args = infer_cli.get_args_parser().parse_args([
        "--weights", weights, "--config", LITE_CONFIGS["s"],
        "--source", osp.join(REPO_ROOT, "data", "images"), "--yaml", data,
        "--img-size", str(IMG), str(IMG),
        "--conf-thres", "0.0", "--max-det", "20", "--save-txt", "--save-dir", str(out),
        "--device", "cpu"])
    infer_cli.run(infer_args)
    labels = sorted(os.listdir(out / "images" / "labels"))
    assert labels == ["image1.txt", "image2.txt", "image3.txt"]
    for name in labels:
        rows = (out / "images" / "labels" / name).read_text().splitlines()
        assert len(rows) == 20 and all(len(r.split()) == 6 for r in rows)
    assert sorted(os.listdir(out / "images"))[:3] == ["image1.jpg", "image2.jpg", "image3.jpg"]


def test_lite_gate_gains_over_the_untrained_model(tmp_path):
    """``learning_gate --gain-over untrained`` on Lite-S at a tiny size (128
    px, 8 train and 4 val images, 2 epochs; no bar): the seed-initialised
    EMA is saved before the first step and evaluated as epoch -1, the gain
    is the final mAP50 less its, and the saved weights are not the trained
    ones."""
    import json

    from yolov6_tpu_torch.tools import learning_gate
    from yolov6_tpu_torch.utils.checkpoint import read_state_dict

    args = learning_gate.get_args_parser().parse_args([
        "--out", str(tmp_path), "--conf-file", LITE_CONFIGS["s"], "--img-size", str(IMG),
        "--n-train", "8", "--n-val", "4", "--epochs", "2", "--batch-size", "4", "--workers",
        "1", "--eval-points", "1", "--skip-exact-nms", "--gain-over", "untrained",
        "--device", "cpu"])
    learning_gate.main(args)
    with open(osp.join(str(tmp_path), "gate_result.json")) as f:
        result = json.load(f)
    traj = result["trajectory"]
    assert [e["epoch"] for e in traj] == [-1, 1] and result["gain_over"] == "untrained"
    assert result["gain"] == pytest.approx(traj[-1]["map50"] - traj[0]["map50"])
    weights = osp.join(str(tmp_path), "train", "gate", "weights")
    untrained = read_state_dict(osp.join(weights, "untrained_ckpt.pt"))
    trained = read_state_dict(osp.join(weights, "1_ckpt.pt"))
    assert untrained.keys() == trained.keys()
    assert any(not torch.equal(untrained[k], trained[k]) for k in untrained
               if untrained[k].is_floating_point())
