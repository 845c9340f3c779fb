"""The port's whole serving request against the JAX package, on the CPU, plus
the port's device rule and its import boundary."""

import os
import re
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


def _serve_both(jmodel, variables, model):
    """Serve the same images through JAX and the port, fp32; check that the
    detections are the same and return the JAX side's."""
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
    return want


def test_serve_matches_jax(models):
    """uint8 BGR NHWC images in, detections out, fp32: the same detections.
    Boxes within rtol 1e-4 / atol 1e-3 px, scores within 1e-5 (the convs sum
    in other orders); counts and classes equal."""
    _serve_both(*models)


def test_serve_matches_jax_with_inverted_boxes(models):
    """The stride-8 level's box regression negated, so its decoded boxes are
    inverted (x2 < x1), as the raw no-DFL regression can give. Such a box
    never suppresses itself: the serve must emit each one once, as the JAX
    serve's default keep does, at the same tolerances."""
    jmodel, variables, _ = models

    def negate_level0(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        return -leaf if names[-2:] == ["reg_preds.0", "bias"] else leaf

    inverted = jax.tree_util.tree_map_with_path(negate_level0, variables)
    model = build_model(small_s_config(Config), num_classes=NC, device="cpu")
    model.load_state_dict(state_dict_from_jax(inverted), strict=True)
    num_j, boxes_j, _, _ = _serve_both(jmodel, inverted, model)
    rows = np.arange(boxes_j.shape[1])[None] < num_j
    assert ((boxes_j[..., 2] < boxes_j[..., 0]) & rows).sum() > 2
    assert ((boxes_j[..., 2] > boxes_j[..., 0]) & rows).sum() > 2


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
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "PIL", "yaml", "yolov6_tpu",
                                    "matplotlib", "tensorboard", "tensorboardX", "tifffile",
                                    "imageio", "webp"))
print("BAD", bad)
print("EXPORT", sorted(n for n in sys.modules if n.startswith(("yolov6_tpu_torch.export.",
      "yolov6_tpu_torch.tools.", "yolov6_tpu_torch.quant."))))
print("MODULES", len([n for n in sys.modules if n.startswith("yolov6_tpu_torch")]))
"""

EXPORT_MODULES = {f"yolov6_tpu_torch.export.{m}" for m in (
    "onnx_proto", "onnx_numpy", "onnx_export", "onnx_quant", "torch_export", "ncnn_export",
    "ncnn_numpy")} | {f"yolov6_tpu_torch.tools.{m}" for m in (
        "export", "infer_torchscript", "onnx_demo", "quantization_ppq")} | {
    "yolov6_tpu_torch.quant.onnx_ptq", "yolov6_tpu_torch.quant.trt_calibrator"}


def _std_includes(source):
    """The ``<...>`` includes of a C++ file and of the headers beside it that
    it includes (``#include "name"``, followed); a quoted name that is no
    file beside it is returned as it stands."""
    with open(source) as f:
        text = f.read()
    out = re.findall(r'^#include\s*<([^>]+)>', text, re.M)
    for name in re.findall(r'^#include\s*"([^"]+)"', text, re.M):
        header = os.path.join(os.path.dirname(source), name)
        out += _std_includes(header) if os.path.isfile(header) else [name]
    return out


def test_port_imports_no_jax_flax_cv2_or_jax_package():
    """Importing every module of the port (its eval, train and infer CLIs,
    the hub, the trainer, the learning gate, the data modules, the
    training recipes' heads and losses, and the export package with its
    tools included) and chip_smoke
    loads none of jax, jaxlib, flax, cv2, PIL, yaml, matplotlib, tensorboard,
    tensorboardX, tifffile, imageio, a libwebp binding or the JAX package; the host
    augmentation library's source includes only the C++ standard library and its build
    links nothing else, and so do the JPEG decoder's, the TIFF and WebP codecs' and the
    MPEG-4 video codec's."""
    res = subprocess.run([sys.executable, "-c", PORT_IMPORT_CHECK], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO_ROOT})
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    loaded = set(eval(res.stdout.split("EXPORT")[1].split("MODULES")[0]))
    assert EXPORT_MODULES <= loaded, EXPORT_MODULES - loaded
    assert int(res.stdout.split("MODULES")[1]) >= 78

    from yolov6_tpu_torch.data import jpeg, native_aug

    includes = _std_includes(native_aug.SOURCE)
    assert includes and set(includes) <= {"algorithm", "cmath", "cstdint", "cstring"}, includes
    includes = _std_includes(jpeg.SOURCE)  # the JPEG decoder: the C++ standard library only
    assert includes and set(includes) <= {"cstddef", "cstdint", "cstdio", "cstring", "exception",
                                          "new", "vector"}, includes
    from yolov6_tpu_torch.data import tiff, webp

    for source in (tiff.SOURCE, webp.SOURCE):  # the C++ standard library only
        includes = _std_includes(source)
        assert includes and set(includes) <= {"algorithm", "cstdint", "cstdio", "cstdlib",
                                              "cstring", "new", "vector"}, (source, includes)
    from yolov6_tpu_torch.data import mpeg4

    includes = _std_includes(mpeg4.SOURCE)  # the video codec: the C++ standard library only
    assert includes and set(includes) <= {"algorithm", "cmath", "cstdarg", "cstddef", "cstdint",
                                          "cstdio", "cstdlib", "cstring", "new", "utility",
                                          "vector"}, includes
    assert not any(flag.startswith(("-l", "-L", "-I")) for flag in native_aug.CXX_FLAGS)
    assert os.path.dirname(native_aug.lib_path()) == os.path.join(REPO_ROOT, "build", "host")
