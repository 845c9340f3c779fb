"""The port's TensorBoard event files (yolov6_tpu_torch/utils/tb_writer.py)
against ``tensorboard`` and against ``torch.utils.tensorboard.SummaryWriter``,
the JAX trainer's writer, and the host copy of the group LRs
(``solver/build.py::group_lrs_host``) against the JAX package's and the
step's in-graph schedule.

Exact: tags, steps, scalar values (float32) and decoded image pixels. The
LRs: equal to JAX's host copy, and to the float32 in-graph schedule within
float32 rounding (rtol 2e-5: the graph computes ``1 - cos`` in float32, which
cancels near epoch 0)."""

import glob
import os.path as osp
import sys

import cv2
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.solver.build import group_lrs_host as jax_group_lrs_host

from yolov6_tpu_torch.solver.build import group_lrs_host, warmup_lr_momentum
from yolov6_tpu_torch.utils.events import write_tbimg, write_tblog
from yolov6_tpu_torch.utils.tb_writer import TBWriter, crc32c, read_events


@pytest.fixture(scope="module", autouse=True)
def no_tensorflow():
    """``tensorboard`` and torch's writer import TensorFlow when it is
    installed (about 15 s); without it they use their own stubs."""
    added = "tensorflow" not in sys.modules
    if added:
        sys.modules["tensorflow"] = None
    yield
    if added:
        del sys.modules["tensorflow"]


def _images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((37, 53), (64, 48))]


def _log(writer, images):
    """The trainer's calls: two epochs of scalars, a train batch, val images."""
    for epoch in range(2):
        write_tblog(writer, epoch, (0.25 + epoch, 0.125 / 3), [0.01 / 3, 0.02, 1e-7 * epoch],
                    [1.5, 0.3 + epoch, np.float32(0.7)])
    write_tbimg(writer, images[0], 5, type="train")
    write_tbimg(writer, images, 1, type="val")
    writer.flush()


def _accumulate(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(logdir, size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}
    images = {t: [(e.step, cv2.imdecode(np.frombuffer(e.encoded_image_string, np.uint8),
                                        cv2.IMREAD_COLOR)[..., ::-1])
                  for e in acc.Images(t)] for t in acc.Tags()["images"]}
    return scalars, images


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from torch.utils.tensorboard import SummaryWriter

    images = _images()
    ours_dir, theirs_dir = (str(tmp_path_factory.mktemp(n)) for n in ("ours", "theirs"))
    ours = TBWriter(ours_dir)
    _log(ours, images)
    ours.close()
    theirs = SummaryWriter(theirs_dir)
    _log(theirs, images)
    theirs.close()
    return images, ours_dir, theirs_dir, ours


def test_crc32c_matches_tensorboard():
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import crc32c as ref

    assert crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(1)
    for n in (0, 1, 5, 4095, 4096, 4097, 70001):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c(data) == ref(data), n


def test_event_file_reads_in_tensorboard_as_torchs(files):
    images, ours_dir, theirs_dir, ours = files
    name = osp.basename(ours.path)
    assert name.startswith("events.out.tfevents.") and len(name.split(".")[3]) == 10
    ours_s, ours_i = _accumulate(ours_dir)
    theirs_s, theirs_i = _accumulate(theirs_dir)
    assert set(ours_s) == {"val/mAP@0.5", "val/mAP@0.50:0.95", "train/iou_loss",
                           "train/dist_focalloss", "train/cls_loss", "x/lr0", "x/lr1", "x/lr2"}
    assert ours_s == theirs_s
    assert ours_s["x/lr0"] == [(1, float(np.float32(0.01 / 3))), (2, float(np.float32(0.01 / 3)))]
    assert sorted(ours_i) == sorted(theirs_i) == ["train_batch", "val_img_1", "val_img_2"]
    want = {"train_batch": [(6, images[0])], "val_img_1": [(2, images[0])],
            "val_img_2": [(2, images[1])]}
    for tag, events in want.items():
        for got, ref, (step, img) in zip(ours_i[tag], theirs_i[tag], events):
            assert got[0] == ref[0] == step
            np.testing.assert_array_equal(got[1], img)
            np.testing.assert_array_equal(ref[1], img)


def test_read_events_reads_torchs_file(files):
    images, ours_dir, theirs_dir, _ = files
    ours = read_events(glob.glob(osp.join(ours_dir, "events.out.tfevents.*"))[0])
    theirs = read_events(glob.glob(osp.join(theirs_dir, "events.out.tfevents.*"))[0])
    assert ours[0]["file_version"] == theirs[0]["file_version"] == "brain.Event:2"

    def flat(events):
        out = []
        for e in events[1:]:
            out += [(e["step"], t, v) for t, v in e.get("scalars", {}).items()]
            out += [(e["step"], t, cv2.imdecode(np.frombuffer(v["png"], np.uint8), 1).tobytes(),
                     v["height"], v["width"], v["colorspace"])
                    for t, v in e.get("images", {}).items()]
        return out

    assert flat(ours) == flat(theirs)
    assert len(flat(ours)) == 16 + 3


def test_read_events_refuses_a_flipped_byte(files, tmp_path):
    _, ours_dir, _, _ = files
    path = glob.glob(osp.join(ours_dir, "events.out.tfevents.*"))[0]
    data = bytearray(open(path, "rb").read())
    first = 16 + int.from_bytes(data[:8], "little")  # the second record's start
    data[first + 12 + 3] ^= 0x40  # a byte of its payload
    bad = tmp_path / "bad"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_events(str(bad))


def test_writer_raises_on_a_directory_it_cannot_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        TBWriter(str(blocker / "logs"))


SOLVERS = [dict(lr0=0.01, lrf=0.01, warmup_bias_lr=0.1, lr_scheduler="Cosine"),
           dict(lr0=0.02, lrf=0.1, warmup_bias_lr=0.0, lr_scheduler="Constant")]


@pytest.mark.parametrize("solver", SOLVERS, ids=["cosine", "constant"])
def test_group_lrs_host_matches_jax_and_the_step(solver):
    epochs, warmup, steps = 30, 40, 20
    for step in (0, 1, 17, 39, 40, 41, 200, 599):
        epoch = float(step // steps)
        got = group_lrs_host(step, epoch, warmup, solver, epochs)
        assert got == jax_group_lrs_host(step, epoch, warmup, solver, epochs), step
        graph = warmup_lr_momentum(torch.tensor(step), epoch, warmup, solver["lr0"],
                                   solver["lrf"], epochs, solver["warmup_bias_lr"], 0.8, 0.937,
                                   solver["lr_scheduler"])
        np.testing.assert_allclose(got, [float(v) for v in graph[:3]], rtol=2e-5, atol=1e-12)
