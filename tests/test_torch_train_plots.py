"""The trainer's TensorBoard images (yolov6_tpu_torch/core/engine.py
``plot_train_batch`` and ``_plot_val_pred``) against the JAX trainer's
(yolov6_tpu/core/engine.py:389-425, :640-682), both called unbound on a
namespace that holds what they read.

The boxes are cv2's ``LINE_8`` rectangles and the resize cv2's INTER_LINEAR
in both, so every pixel is equal outside the text: the JAX side writes
Hershey glyphs with ``cv2.putText``, the port its 5x7 font. Excluded are the
pixels of each cv2 text and the box of each port text, dilated by 2 px, and
after a resize the excluded region resized and dilated by 2 px again."""

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
from yolov6_tpu_torch.utils.draw import get_text_size

NAMES = ["circle", "square", "triangle", "ring", "person-with-a-long-name"]
KERNEL = np.ones((5, 5), np.uint8)  # 2 px each way


class TextCalls:
    """Records the text calls of both sides while installed."""

    def __init__(self, monkeypatch):
        self.cv2, self.port = [], []
        self.real_cv2 = real_cv2 = cv2.putText
        real_port = engine.put_text

        def cv2_spy(img, text, org, font, scale, color, thickness=1, *a, **k):
            self.cv2.append((text, tuple(org), font, scale, thickness))
            return real_cv2(img, text, org, font, scale, color, thickness, *a, **k)

        def port_spy(img, text, org, scale, color, thickness):
            self.port.append((text, tuple(org), scale, thickness))
            return real_port(img, text, org, scale, color, thickness)

        monkeypatch.setattr(cv2, "putText", cv2_spy)
        monkeypatch.setattr(engine, "put_text", port_spy)

    def mask(self, shape, out_shape=None, cv2_calls=None, port_calls=None):
        """The excluded pixels (module doc) of a canvas of ``shape`` (h, w)
        for the given calls (all by default), resized to ``out_shape`` if
        given."""
        m = np.zeros(shape, np.uint8)
        for text, org, font, scale, thickness in (self.cv2 if cv2_calls is None else cv2_calls):
            self.real_cv2(m, text, org, font, scale, 255, thickness)
        for text, (x, y), scale, thickness in (self.port if port_calls is None else port_calls):
            w, h = get_text_size(text, scale, thickness)
            m[max(y - h, 0):max(y + 1, 0), max(x, 0):max(x + w, 0)] = 255
        m = cv2.dilate(m, KERNEL)
        if out_shape is not None:
            m = cv2.dilate(cv2.resize(m, out_shape[::-1]), KERNEL)
        return m > 0


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
    grid = int(np.ceil(n ** 0.5)) * size
    mask = calls.mask((grid, grid), None if grid == out else (out, out))
    assert 0.001 < mask.mean() < 0.2
    np.testing.assert_array_equal(ours[~mask], theirs[~mask])
    assert (ours[mask] != theirs[mask]).any()  # the fonts differ


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
    assert len(calls.cv2) == len(calls.port) > 8
    # each image's texts: the calls that name a row of that image, in order
    # (an image's rows are drawn before the next image is read)
    by_image = {}
    for d in preds:
        by_image.setdefault(d["image_id"], []).append(d)
    start = 0
    for (_, _, got), (_, _, want), rows in zip(ours.tblogger.images, theirs.tblogger.images,
                                               by_image.values()):
        best = sorted(rows, key=lambda d: -d["score"])[:5]
        n = sum(d["score"] >= 0.3 for d in best)
        mask = calls.mask(got.shape[:2], cv2_calls=calls.cv2[start:start + n],
                          port_calls=calls.port[start:start + n])
        start += n
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[~mask], want[~mask])
    assert start == len(calls.port)
