"""The trainer's TensorBoard images (yolov6_tpu_torch/core/engine.py
``plot_train_batch`` and ``_plot_val_pred``) against the JAX trainer's
(yolov6_tpu/core/engine.py:389-425, :640-682), both called unbound on a
namespace that holds what they read.

The boxes are cv2's ``LINE_8`` rectangles, the text ``cv2.putText``'s (the
port's utils/text.py) and the resize cv2's INTER_LINEAR in both, so every
pixel is equal; each side's text calls are recorded and must be the same
calls."""

import glob
import os.path as osp
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from yolov6_tpu.core.engine import Trainer as JaxTrainer

from yolov6_tpu_torch.core import engine
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.utils.data_config import load_data_config

NAMES = ["circle", "square", "triangle", "ring", "person-with-a-long-name"]


class TextCalls:
    """Records the text calls of both sides while installed."""

    def __init__(self, monkeypatch):
        self.cv2, self.port = [], []
        real_cv2, real_port = cv2.putText, engine.put_text

        def cv2_spy(img, text, org, font, scale, color, thickness=1, *a, **k):
            self.cv2.append((text, tuple(org), font, scale, tuple(color), thickness))
            return real_cv2(img, text, org, font, scale, color, thickness, *a, **k)

        def port_spy(img, text, org, font, scale, color, thickness=1, *a, **k):
            self.port.append((text, tuple(org), font, scale, tuple(color), thickness))
            return real_port(img, text, org, font, scale, color, thickness, *a, **k)

        monkeypatch.setattr(cv2, "putText", cv2_spy)
        monkeypatch.setattr(engine, "put_text", port_spy)


def _batch(n, size, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    labels = np.full((n, 6, 5), -1.0, np.float32)
    labels[..., 1:] = 0.0
    for i in range(n):
        k = int(rng.integers(0, 7))
        cxcy = rng.uniform(0.0, 1.0, (k, 2))
        wh = rng.uniform(0.05, 0.6, (k, 2))
        labels[i, :k] = np.concatenate([rng.integers(0, len(NAMES), (k, 1)), cxcy, wh], 1)
    paths = [f"/data/images/train/{'img_with_a_rather_long_file_name_' * (i % 2)}{i:06d}.png"
             for i in range(n)]
    return imgs, labels, paths


@pytest.mark.parametrize("n,size,out", [(4, 160, 320), (16, 640, 1920)],
                         ids=["4_tiles_160", "16_tiles_640_resized"])
def test_plot_train_batch_matches_jax(n, size, out, monkeypatch):
    imgs, labels, paths = _batch(n, size, seed=size)
    ns = SimpleNamespace(data_dict={"names": NAMES})
    calls = TextCalls(monkeypatch)
    theirs = JaxTrainer.plot_train_batch(ns, imgs, labels, paths)
    ours = engine.Trainer.plot_train_batch(ns, imgs, labels, paths)
    assert ours.shape == theirs.shape == (out, out, 3) and ours.dtype == np.uint8
    assert calls.port == calls.cv2 and len(calls.port) >= n
    np.testing.assert_array_equal(ours, theirs)


def test_plot_val_pred_matches_jax(tmp_path, monkeypatch):
    data = load_data_config(generate_synth_dataset(str(tmp_path), n_train=0, n_val=10,
                                                   img_size=96, nc=4, seed=5))
    paths = sorted(glob.glob(osp.join(data["val"], "*.png")))
    rng = np.random.default_rng(6)
    preds = []
    for p in paths[:9]:  # the tenth image has no row
        stem = osp.splitext(osp.basename(p))[0]
        image_id = int(stem) if stem.isnumeric() else stem
        for _ in range(int(rng.integers(1, 9))):
            x, y = rng.uniform(-10, 90, 2)
            w, h = rng.uniform(5, 60, 2)
            preds.append({"image_id": image_id, "category_id": int(rng.integers(0, 4)),
                          "bbox": [round(float(v), 3) for v in (x, y, w, h)],
                          "score": round(float(rng.uniform(0.1, 1.0)), 5)})

    class Logger:
        def __init__(self):
            self.images = []

        def add_image(self, tag, img, step, dataformats="HWC"):
            self.images.append((tag, step, np.asarray(img).copy()))

        def flush(self):
            pass

    def namespace():
        return SimpleNamespace(
            data_dict=data, ids_to_contig={i: i for i in range(4)}, tblogger=Logger(), epoch=2,
            val_loader=SimpleNamespace(dataset=SimpleNamespace(img_paths=paths)))

    theirs, ours = namespace(), namespace()
    calls = TextCalls(monkeypatch)
    JaxTrainer._plot_val_pred(theirs, preds)
    engine.Trainer._plot_val_pred(ours, preds)
    assert [t[:2] for t in ours.tblogger.images] == [t[:2] for t in theirs.tblogger.images] == [
        (f"val_img_{i}", 3) for i in range(1, 9)]
    assert calls.port == calls.cv2 and len(calls.port) > 8
    for (_, _, got), (_, _, want) in zip(ours.tblogger.images, theirs.tblogger.images):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
