"""A dataset and an inference source of mixed formats through the JAX
package and the port: TIFF (LZW, Deflate, JPEG-in-TIFF), WebP (lossy,
lossless, animated), MPO and a PNG with Exif orientation 6.

- Dataset: the port's ``TrainValDataset`` and loader against the JAX
  package's, with and without ``check_images``: the scan's paths and
  shapes, the label caches' entries, the val loader's batches and the train
  samples (mosaic, the JAX package's draws seeded as the port's) equal.
  Tolerance: none (every image is at most 64 pixels a side at img_size 64,
  so nothing is resized in val mode, and the train path's INTER_LINEAR is
  bit-equal, tests/test_torch_train_data.py).
- Inference: the port's ``Inferer`` and the JAX package's over a ``.tif``
  and a ``.webp`` source with the same small N weights: the label rows as
  tests/test_torch_inferer.py holds them (1e-4), each drawn image written
  in its source's format; the written TIFF is cv2's bytes of the drawn
  pixels and the written WebP reads back to them under ``cv2.imread``.
"""

import io
import json
import os
import random
import re
import shutil

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.core.inferer import Inferer as JaxInferer
from yolov6_tpu.data.data_load import create_dataloader as jax_create_dataloader
from yolov6_tpu.data.datasets import TrainValDataset as JaxDataset
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.core.inferer import Inferer
from yolov6_tpu_torch.data.data_augment import sample_seed
from yolov6_tpu_torch.data.data_load import create_dataloader
from yolov6_tpu_torch.data.datasets import TrainValDataset
from yolov6_tpu_torch.data.image_io import image_format, imread
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_image_fixtures import (
    FIXTURES, exif_after_idat, hand_tiff, jpeg_tables_split, smooth_image,
)
from torch_port_utils import N_CONFIG, REPO_ROOT, random_jax_variables

IMG, SEED = 64, 3


def _webp(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[:, :, ::-1])).save(buf, format="WEBP", **kw)
    return buf.getvalue()


def _mixed_files():
    """name -> bytes: every image at most 64 pixels a side."""
    files = {}
    rgb = lambda h, w, s: np.ascontiguousarray(smooth_image(h, w, s)[:, :, ::-1])  # noqa: E731
    for name, (h, w), kw in (("lzw.tif", (48, 64), dict(compression="tiff_lzw")),
                             ("deflate.tif", (64, 48), dict(compression="tiff_adobe_deflate"))):
        buf = io.BytesIO()
        Image.fromarray(rgb(h, w, len(name))).save(buf, format="TIFF", **kw)
        files[name] = buf.getvalue()
    img = smooth_image(40, 64, 5)
    tables, image = jpeg_tables_split(cv2.imencode(".jpg", img)[1].tobytes())
    files["ycbcr.tif"] = hand_tiff(64, 40, [(258, 3, [8] * 3), (259, 3, [7]), (262, 3, [6]),
                                            (277, 3, [3]), (347, 7, list(tables)),
                                            (530, 3, [2, 2])], [image])
    files["lossy.webp"] = _webp(smooth_image(52, 64, 6), quality=80)
    files["lossless.webp"] = _webp(smooth_image(64, 60, 7), lossless=True)
    frames = [Image.fromarray(rgb(64, 64, 8)), Image.fromarray(rgb(64, 64, 9))]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], lossless=True,
                   duration=40)
    files["anim.webp"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgb(44, 64, 10)).save(buf, format="MPO", save_all=True,
                                          append_images=[Image.fromarray(rgb(44, 64, 11))])
    files["two.mpo"] = buf.getvalue()
    ex = Image.Exif()
    ex[274] = 6
    buf = io.BytesIO()
    Image.fromarray(rgb(40, 64, 12)).save(buf, format="PNG", exif=ex.tobytes())
    files["exif6.png"] = exif_after_idat(buf.getvalue())
    return files


def _write_set(root):
    files = _mixed_files()
    for split in ("train", "val"):
        for kind in ("images", "labels"):
            os.makedirs(os.path.join(root, kind, split), exist_ok=True)
        for k, (name, data) in enumerate(sorted(files.items())):
            with open(os.path.join(root, "images", split, name), "wb") as f:
                f.write(data)
            with open(os.path.join(root, "labels", split, os.path.splitext(name)[0] + ".txt"),
                      "w") as f:
                f.write(f"{k % 3} 0.5 0.5 0.4 0.3\n{(k + 1) % 3} 0.3 0.6 0.2 0.2\n")
    return {split: os.path.join(root, "images", split) for split in ("train", "val")}


def _cache(root, split, suffix):
    with open(os.path.join(root, "images", f".{split}.{suffix}.json")) as f:
        labels = json.load(f)["labels"]
    return {os.path.relpath(p, root): v for p, v in labels.items()}


@pytest.mark.parametrize("check_images", [False, True], ids=["scan", "check_images"])
def test_mixed_format_set_equals_jax(tmp_path, check_images):
    ours, theirs = _write_set(str(tmp_path / "ours")), _write_set(str(tmp_path / "theirs"))
    data = dict(nc=3, names=["a", "b", "c"])
    kw = dict(img_size=IMG, batch_size=4, task="val", num_workers=2, max_labels=4,
              check_images=check_images)
    loader, ds = create_dataloader(ours["val"], data_dict=dict(data), **kw)
    loader_j, ds_j = jax_create_dataloader(theirs["val"], data_dict=dict(data), **kw)
    base = lambda d: [os.path.basename(p) for p in d.img_paths]  # noqa: E731
    assert base(ds) == base(ds_j) and len(ds) == 8
    np.testing.assert_array_equal(ds.shapes, ds_j.shapes)
    shapes = dict(zip(base(ds), ds.shapes.tolist()))
    assert shapes["exif6.png"] == [40, 64] and shapes["ycbcr.tif"] == [64, 40]
    assert _cache(str(tmp_path / "ours"), "val", "torch_cache") == _cache(
        str(tmp_path / "theirs"), "val", "tpu_cache")
    got, want = list(loader), list(loader_j)
    assert len(got) == len(want) == 2
    for (imgs, labels, paths, shp, n), (imgs_j, labels_j, paths_j, shp_j, n_j) in zip(got, want):
        np.testing.assert_array_equal(imgs, imgs_j)
        np.testing.assert_array_equal(labels, labels_j)
        assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in paths_j]
        assert n == n_j and [s[0] for s in shp] == [s[0] for s in shp_j]
    # the train path (the port's own RGB decode) against the JAX package's native one
    hyp = dict(mosaic=1.0, mixup=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=5.0,
               translate=0.1, scale=0.5, shear=1.0, flipud=0.5, fliplr=0.5)
    train = TrainValDataset(ours["train"], img_size=IMG, batch_size=4, augment=True, hyp=hyp,
                            task="train", data_dict=dict(data), seed=SEED,
                            check_images=check_images)
    train_j = JaxDataset(theirs["train"], img_size=IMG, batch_size=4, augment=True, hyp=hyp,
                         task="train", data_dict=dict(data), check_images=check_images)
    for index in range(len(train)):
        seed = sample_seed(SEED, 0, index)
        random.seed(seed)
        np.random.seed(seed)
        img_j, labels_j, _, _ = train_j[index]
        img, labels, _, _ = train[index]
        np.testing.assert_array_equal(img, img_j)
        np.testing.assert_array_equal(labels, labels_j)


INFER = dict(conf_thres=0.3, iou_thres=0.45, max_det=1000, classes=None, agnostic_nms=False,
             save_txt=True, save_img=True, hide_labels=False, hide_conf=False)
INFER_IMG, NC = 160, 4


def _small_n_config_file(path):
    with open(N_CONFIG) as f:
        src = f.read()
    src = re.sub(r"depth_multiple=[0-9.]+", "depth_multiple=0.1", src)
    src = re.sub(r"width_multiple=[0-9.]+", "width_multiple=0.0625", src)
    with open(path, "w") as f:
        f.write(src)
    return str(path)


def test_inferer_writes_tiff_and_webp_as_jax(tmp_path):
    """Each drawn image goes out under its source's name and format, as the
    JAX inferer's ``cv2.imwrite`` writes it. The boxes come from two
    packages' float arithmetic (rows equal within 1e-4, not bit for bit), so
    the drawn pixels are not held against the JAX package's here (the
    drawing itself is: tests/test_torch_inferer.py); each source also goes in
    under a ``.png`` name: the written TIFF is byte for byte
    ``cv2.imencode('.tif')`` of that PNG's pixels, and the written WebP reads
    back under ``cv2.imread`` to them exactly."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(os.path.join(FIXTURES, "infer_source.webp"), src / "scene.webp")
    demo = cv2.imread(os.path.join(REPO_ROOT, "data", "images", "image1.jpg"))
    Image.fromarray(demo[:, :, ::-1].copy()).save(src / "scene.tif", compression="tiff_lzw")
    for name in ("scene.webp", "scene.tif"):  # the same bytes under a PNG's name
        shutil.copy(src / name, src / f"{name.replace('.', '_')}.png")
    yaml_path = tmp_path / "data.yaml"
    yaml_path.write_text(f"nc: {NC}\nnames: {['person', 'light', 'car', 'bear']}\n")
    cfg = _small_n_config_file(tmp_path / "small_n.py")
    jmodel = jax_build_model(JaxConfig.fromfile(cfg), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, INFER_IMG, INFER_IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=41)
    ckpt = jax_save_checkpoint({"model": variables}, False, str(tmp_path), "small_n")
    weights = str(tmp_path / "small_n.pt")
    torch.save(state_dict_from_jax(variables), weights)
    theirs = JaxInferer(str(src), False, "0", ckpt, cfg, str(yaml_path), INFER_IMG, False)
    ours = Inferer(str(src), False, "0", weights, cfg, str(yaml_path), INFER_IMG, False,
                   device="cpu")
    out, out_j = str(tmp_path / "ours"), str(tmp_path / "theirs")
    ours.infer(save_dir=out, **INFER)
    theirs.infer(save_dir=out_j, **INFER)
    for name, fmt in (("scene.tif", "tiff"), ("scene.webp", "webp")):
        mine, jax_file = os.path.join(out, "src", name), os.path.join(out_j, "src", name)
        assert image_format(mine) == fmt
        with Image.open(jax_file) as im:
            assert im.format.lower() == fmt
        drawn = cv2.imread(os.path.join(out, "src", f"{name.replace('.', '_')}.png"))
        assert drawn.shape == cv2.imread(jax_file).shape == imread(mine).shape
        if fmt == "tiff":
            with open(mine, "rb") as f:
                assert f.read() == cv2.imencode(".tif", drawn)[1].tobytes()
        else:
            np.testing.assert_array_equal(cv2.imread(mine), drawn)
        np.testing.assert_array_equal(imread(mine), drawn)
    labels = sorted(os.listdir(os.path.join(out, "src", "labels")))
    # scene.tif and scene.webp share scene.txt: the rows of both, appended
    assert labels == sorted(os.listdir(os.path.join(out_j, "src", "labels"))) and len(labels) == 3
    n_rows = 0
    for name in labels:
        with open(os.path.join(out, "src", "labels", name)) as a, open(
                os.path.join(out_j, "src", "labels", name)) as b:
            rows = [list(map(float, r.split())) for r in a.read().splitlines()]
            rows_j = [list(map(float, r.split())) for r in b.read().splitlines()]
        assert len(rows) == len(rows_j)
        n_rows += len(rows)
        key = lambda r: (-r[5], r[0])  # noqa: E731
        for r, r_j in zip(sorted(rows, key=key), sorted(rows_j, key=key)):
            assert r[0] == r_j[0]
            np.testing.assert_allclose(r[1:], r_j[1:], rtol=0, atol=1e-4)
    assert n_rows > 0
