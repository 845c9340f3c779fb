"""The port's trainer across two gloo ranks (yolov6_tpu_torch/tools/train.py,
core/engine.py, core/evaler.py::gather_coco_predictions) on the CPU, on the
tiny set of tests/test_torch_trainer.py (8 train and 4 val PNG images at 64
px) with configs/yolov6n.py at full width, global batch 4 (2 a rank).

One spawn of two ranks trains 2 epochs through ``tools/train.py::main``
(the strong augmentation off for the second, an eval at the end at conf 0,
so that the untrained model gives rows), then resumes a copy of the run
from its epoch-0 checkpoint for the second epoch. Checked, without
tolerance:
- each epoch the ranks' shards together take every train image once;
  ``DataLoader``'s shards are the JAX loader's (padded by wrap-around for
  training, not for eval);
- rank 0's gathered COCO rows equal, row for row, a one-process ``Evaler``'s
  on the run's final EMA checkpoint at the rank batch, and both ranks hold
  the APs that one-process evaluator scores;
- rank 1 opens no file for writing, makes no directory and replaces no file
  under the output directory; rank 0 wrote the run (one run directory);
- the resumed run's state equals the straight run's bit for bit on both
  ranks.
"""

import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from yolov6_tpu_torch.parallel.dist import barrier
from yolov6_tpu_torch.tools import train as train_cli

from chip_smoke import record_writes
from torch_dist_utils import run_ranks
from torch_port_utils import N_CONFIG

BATCH, WORLD = 4, 2


def _args(data, out, conf, *extra):
    return train_cli.get_args_parser().parse_args([
        "--data-path", data, "--conf-file", conf, "--img-size", "64", "--img-floor", "64",
        "--batch-size", str(BATCH), "--workers", "2", "--heavy-eval-range", "0",
        "--output-dir", out, "--name", "run", "--max-labels", "8", "--log-interval", "1",
        "--seed", "0", "--device", "cpu", *extra])


def _seen(trainer):
    """Per epoch, the train indices this rank's loader took."""
    loader, out = trainer.train_loader, []
    for stats in trainer.epoch_stats:
        loader.set_epoch(stats["epoch"])
        out.append(loader._indices()[:stats["steps"] * loader.batch_size])
    return out


def _rank(rank, world, data, out, conf):
    writes = record_writes(osp.abspath(out)) if rank == 1 else None
    args = _args(data, out, conf, "--epochs", "2", "--eval-final-only",
                 "--stop_aug_last_n_epoch", "1", "--save_ckpt_on_last_n_epoch", "2")
    straight = train_cli.main(args)
    res = dict(save_dir=straight.save_dir, predictions=straight.predictions,
               results=straight.evaluate_results, seen=_seen(straight),
               val_shard=straight.val_loader._indices(),
               state=straight.train_step.state_dict())
    copy = osp.join(out, "copy")
    if rank == 0:
        shutil.copytree(straight.save_dir, copy)
        os.remove(osp.join(copy, "weights", "1_ckpt.pt"))
    barrier()
    rargs = train_cli.get_args_parser().parse_args(
        ["--resume", osp.join(copy, "weights", "0_ckpt.pt"), "--device", "cpu"])
    resumed = train_cli.main(rargs)
    res.update(resumed_start=resumed.start_epoch, resumed_state=resumed.train_step.state_dict(),
               resumed_results=resumed.evaluate_results, writes=writes)
    return res


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset

    root = tmp_path_factory.mktemp("tiny_train_ddp")
    data = generate_synth_dataset(str(root / "set"), n_train=8, n_val=4, img_size=64, nc=3,
                                  seed=0, sizes=[(64, 64), (80, 60), (48, 64)])
    conf = root / "yolov6n_conf0.py"
    with open(N_CONFIG) as f:
        conf.write_text(f.read() + "\neval_params = dict(conf_thres=0.0)\n")
    out = str(root / "out")
    ranks = run_ranks(_rank, WORLD, data, out, str(conf))
    return dict(data=data, out=out, conf=str(conf), ranks=ranks)


def test_ranks_share_every_train_image_once_an_epoch(run):
    r0, r1 = run["ranks"]
    assert len(r0["seen"]) == len(r1["seen"]) == 2
    for a, b in zip(r0["seen"], r1["seen"]):
        assert len(a) == len(b) == 4 and sorted(a + b) == list(range(8))
    assert r0["val_shard"] == [0, 1] and r1["val_shard"] == [2, 3]


@pytest.mark.parametrize("n", [9, 8])
def test_shards_are_the_jax_loaders(n):
    """The port's shard of a shuffled epoch, padded for training and not for
    eval, is the JAX ``DataLoader``'s."""
    import conftest  # noqa: F401  (JAX on the CPU)

    from yolov6_tpu.data.data_load import DataLoader as JaxDataLoader
    from yolov6_tpu_torch.data.data_load import DataLoader

    class Sized:
        def __len__(self):
            return n

    for pad in (True, False):
        for shard in range(3):
            kw = dict(batch_size=2, shuffle=True, seed=4, shard_id=shard, num_shards=3,
                      pad_shards=pad)
            ours, theirs = DataLoader(Sized(), **kw), JaxDataLoader(Sized(), **kw)
            for epoch in (0, 1):
                ours.epoch = theirs.epoch = epoch
                assert ours._indices() == list(theirs._indices()), (pad, shard, epoch)


def test_gathered_rows_equal_one_process_evaler(run):
    from yolov6_tpu_torch.core.evaler import Evaler
    from yolov6_tpu_torch.models.yolo import build_model
    from yolov6_tpu_torch.utils.checkpoint import load_checkpoint
    from yolov6_tpu_torch.utils.config import Config
    from yolov6_tpu_torch.utils.data_config import load_data_config

    r0, r1 = run["ranks"]
    model = build_model(Config.fromfile(run["conf"]), 3, deploy=False, device="cpu")
    ema = load_checkpoint(osp.join(r0["save_dir"], "weights", "last_ckpt.pt"))["model"]
    model.load_state_dict(ema, strict=True)
    evaler = Evaler(load_data_config(run["data"]), batch_size=BATCH // WORLD, img_size=64,
                    conf_thres=0.0, iou_thres=0.65, device="cpu")
    evaler.init_model(model)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank ran
    try:
        rows = evaler.predict_model(model, evaler.init_data(None, "val"), task="train")
    finally:
        torch.set_num_threads(threads)
    assert len(rows) > 4 * 100  # conf 0: every image gives rows
    assert r0["predictions"] == rows
    results = evaler.eval_model(rows, model, None, task="train")
    assert r0["results"] == r1["results"] == tuple(float(v) for v in results)


def test_only_rank_zero_writes(run):
    r0, r1 = run["ranks"]
    assert r1["writes"] == []
    assert r0["save_dir"] == r1["save_dir"] == osp.join(run["out"], "run")
    assert sorted(os.listdir(run["out"])) == ["copy", "run"]
    run_dir = r0["save_dir"]
    # rank 0's TensorBoard event file is the one file beside these (rank 1
    # wrote nothing, above)
    files = sorted(os.listdir(run_dir))
    events = [f for f in files if f.startswith("events.out.tfevents.")]
    assert len(events) == 1
    assert [f for f in files if f not in events] == ["args.yaml", "predictions.json", "weights"]
    assert sorted(os.listdir(osp.join(run_dir, "weights"))) == [
        "0_ckpt.pt", "1_ckpt.pt", "best_ckpt.pt", "best_stop_aug_ckpt.pt", "last_ckpt.pt"]


def test_resume_on_two_ranks_continues_bit_for_bit(run):
    for r in run["ranks"]:
        assert r["resumed_start"] == 1
        assert sorted(r["resumed_state"]) == sorted(r["state"])
        for key, want in r["state"].items():
            assert torch.equal(r["resumed_state"][key], want), key
        assert r["resumed_results"] == r["results"]
    np.testing.assert_array_equal(run["ranks"][0]["state"]["params"],
                                  run["ranks"][1]["state"]["params"])
