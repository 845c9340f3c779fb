"""The port's whole serving request against the JAX package, on the CPU, plus
the port's device rule and its import boundary."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.models.end2end import make_end2end_fn as jax_make_end2end_fn
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.models.end2end import make_end2end_fn
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import REPO_ROOT, random_jax_variables, small_s_config

IMG, NC = 128, 80


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(small_s_config(JaxConfig), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    )
    variables = random_jax_variables(shapes, seed=5)
    model = build_model(small_s_config(Config), num_classes=NC, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def test_serve_matches_jax(models):
    """uint8 BGR NHWC images in, detections out, fp32: the same detections.
    Boxes within rtol 1e-4 / atol 1e-3 px, scores within 1e-5 (the convs sum
    in other orders); counts and classes equal."""
    jmodel, variables, model = models
    images = np.random.default_rng(6).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, with_preprocess=True, half=False)
    want = [np.asarray(a) for a in jax_make_end2end_fn(jmodel, variables, **kw)(jnp.asarray(images))]
    got = [t.numpy() for t in make_end2end_fn(model, device="cpu", **kw)(images)]
    num_j, boxes_j, scores_j, cls_j = want
    num_t, boxes_t, scores_t, cls_t = got
    assert num_t.dtype == np.int32 and cls_t.dtype == np.int32
    assert num_t.shape == (2, 1) and boxes_t.shape == (2, 100, 4)
    assert num_j.min() > 10
    np.testing.assert_array_equal(num_t, num_j)
    np.testing.assert_array_equal(cls_t, cls_j)
    np.testing.assert_allclose(boxes_t, boxes_j, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(scores_t, scores_j, rtol=0, atol=1e-5)


def test_serve_half_on_cpu(models):
    """bf16 serving runs and gives finite, well-formed detections."""
    _, _, model = models
    images = np.random.default_rng(7).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    num, boxes, scores, cls = make_end2end_fn(model, with_preprocess=True, half=True,
                                              device="cpu")(images)
    assert boxes.dtype == torch.float32 and torch.isfinite(boxes).all()
    assert int(num.min()) > 0
    valid = torch.arange(100)[None] < num
    assert (scores[valid] > 0.25).all() and (scores[~valid] == 0).all()
    assert ((cls >= 0) & (cls < NC)).all()


def test_entry_points_need_a_device_without_cuda(models, monkeypatch):
    _, _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(small_s_config(Config), num_classes=NC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_end2end_fn(model)


PORT_IMPORT_CHECK = r"""
import pkgutil, importlib, sys
import yolov6_tpu_torch
for m in pkgutil.walk_packages(yolov6_tpu_torch.__path__, "yolov6_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "yolov6_tpu"))
print("BAD", bad)
print("MODULES", len([n for n in sys.modules if n.startswith("yolov6_tpu_torch")]))
"""


def test_port_imports_no_jax_flax_cv2_or_jax_package():
    res = subprocess.run([sys.executable, "-c", PORT_IMPORT_CHECK], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO_ROOT})
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert int(res.stdout.split("MODULES")[1]) >= 15
