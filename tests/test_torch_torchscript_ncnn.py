"""The port's TorchScript and NCNN exports (export/torch_export.py,
export/ncnn_export.py) on the CPU.

- TorchScript: small S traced (deploy model plus decode over NHWC fp32
  images, the reference's own route), saved, loaded with ``torch.jit.load``:
  equal to the port's forward plus decode exactly; ``OnnxTorchModule`` runs
  the port's ONNX file of the same model as torch ops within the ONNX
  check's atol 5e-4 / rtol 1e-4.
- NCNN: Lite-S at full width from seeded JAX variables (``random_lite_
  variables``), carried across by ``state_dict_from_jax``: the port's
  ``.param`` and ``.bin`` byte-equal to the JAX ``export_ncnn(model,
  variables, prefix)`` of the same weights, in fp32 and fp16; the port's
  ``NcnnRunner`` on them equals the port's lite head maps (``[sigmoid(cls);
  reg]`` a level) within the JAX CLI's tolerances, 2e-4 in fp32 and 2e-2 in
  fp16.
"""

import functools
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.export.ncnn_export import export_ncnn as jax_export_ncnn
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.export.ncnn_export import export_ncnn
from yolov6_tpu_torch.export.ncnn_numpy import NcnnRunner
from yolov6_tpu_torch.export.onnx_export import export_onnx
from yolov6_tpu_torch.export.torch_export import DeployForward, OnnxTorchModule, export_torchscript
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import REPO_ROOT, random_jax_variables, random_lite_variables, small_s_config

LITE_S = os.path.join(REPO_ROOT, "configs", "yolov6_lite", "yolov6_lite_s.py")
NC = 80


def _port_model(make_cfg, img, seed, lite=False):
    jmodel = jax_build_model(make_cfg(JaxConfig), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False))
    variables = (random_lite_variables if lite else random_jax_variables)(shapes, seed=seed)
    model = build_model(make_cfg(Config), num_classes=NC, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def test_torchscript_equals_forward(tmp_path):
    _, _, model = _port_model(small_s_config, 96, seed=51)
    x = np.random.default_rng(0).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    path = str(tmp_path / "s.torchscript.pt")
    export_torchscript(model, (x,), path)
    loaded = torch.jit.load(path)
    with torch.no_grad():
        got = loaded(torch.from_numpy(x))
        want = DeployForward(model)(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 189, 5 + NC)
    assert torch.equal(got, want)
    onnx = export_onnx(DeployForward(model), (x,), input_names=["images"],
                       output_names=["outputs"])
    with torch.no_grad():
        via_onnx = OnnxTorchModule(onnx)(torch.from_numpy(x))
    torch.testing.assert_close(via_onnx, want, atol=5e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _lite():
    return _port_model(lambda c: c.fromfile(LITE_S), 128, seed=52, lite=True)


@pytest.mark.parametrize("fp16", [False, True], ids=["fp32", "fp16"])
def test_ncnn_files_byte_equal_jax(tmp_path, fp16):
    jmodel, variables, model = _lite()
    port = export_ncnn(model, str(tmp_path / "port"), fp16=fp16)
    jax_files = jax_export_ncnn(jmodel, variables, str(tmp_path / "jax"), fp16=fp16)
    for mine, theirs in zip(port, jax_files):
        with open(mine, "rb") as f, open(theirs, "rb") as g:
            assert f.read() == g.read(), os.path.basename(mine)


@pytest.mark.parametrize("fp16", [False, True], ids=["fp32", "fp16"])
def test_ncnn_runner_equals_head_maps(tmp_path, fp16):
    _, _, model = _lite()
    prefix = str(tmp_path / "lite")
    export_ncnn(model, prefix, fp16=fp16)
    img = np.random.default_rng(1).uniform(0, 1, (128, 128, 3)).astype(np.float32)
    blobs = NcnnRunner(prefix + ".param", prefix + ".bin")(img.transpose(2, 0, 1))
    with torch.no_grad():
        head, _ = model(torch.from_numpy(img.transpose(2, 0, 1)[None].copy()))
    tol = 2e-2 if fp16 else 2e-4
    assert len(head["cls"]) == 4
    for i, (cls, reg) in enumerate(zip(head["cls"], head["reg"])):
        want = torch.cat([torch.sigmoid(cls[0]), reg[0]], 0).numpy()
        assert blobs[f"out{i}"].shape == want.shape
        np.testing.assert_allclose(blobs[f"out{i}"], want, rtol=tol, atol=tol, err_msg=f"{i}")
