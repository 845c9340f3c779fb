"""The port's ``.pt2`` serving artifact (models/end2end.py::export_program,
load_serving) against the live port serve and the JAX package's serve, on
the CPU.

Small S (no DFL) and small M (DFL) at 96 px, 80 classes, from the same
seeded JAX variables carried across by ``state_dict_from_jax``. Each is
exported end2end once per module, in fp32 with the preprocessing folded in,
loaded with ``load_serving`` and called:

- against the live port serve on the same images: the keep identical
  (num_dets, classes, and the valid rows), boxes and scores within 1e-6;
- against the JAX ``make_end2end_fn`` serve: counts and classes equal,
  boxes rtol 1e-4 / atol 1e-3 px, scores atol 1e-5, the CPU decode
  tolerances of tests/test_torch_end2end.py.

The exported graph holds the keep as one ``yolov6.greedy_nms`` node. The
bf16 artifact (``--half``: bf16 weights, decode and NMS in fp32) keeps as
the live bf16 serve does on these images. The parts of the JAX export that
are not ported raise, naming ROADMAP.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.models.end2end import make_end2end_fn as jax_make_end2end_fn
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.models import end2end
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import random_jax_variables, small_m_config, small_s_config

IMG, NC, BATCH = 96, 80, 2
SERVE = dict(conf_thres=0.25, iou_thres=0.45, max_det=100)
CONFIGS = {"s": small_s_config, "m_dfl": small_m_config}


def _pair(name, seed):
    jmodel = jax_build_model(CONFIGS[name](JaxConfig), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=seed)
    model = build_model(CONFIGS[name](Config), num_classes=NC, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def exported(request, tmp_path_factory):
    """Each graph exported end2end in fp32 (uint8 input, preprocessing in the
    graph) once, loaded back, beside its JAX twin."""
    jmodel, variables, model = _pair(request.param, seed=11)
    path = str(tmp_path_factory.mktemp("pt2") / f"{request.param}.pt2")
    module = end2end.export_serve_module(model, **SERVE, with_preprocess=True, half=False)
    end2end.export_program(module, BATCH, (IMG, IMG), path, input_dtype=torch.uint8)
    return jmodel, variables, model, end2end.load_serving(path, device="cpu")


def _images(seed=3):
    return np.random.default_rng(seed).integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)


def test_artifact_specs_and_graph(exported):
    _, _, _, art = exported
    assert art.in_specs == [((BATCH, IMG, IMG, 3), torch.uint8)]
    assert art.out_specs == [((BATCH, 1), torch.int32), ((BATCH, 100, 4), torch.float32),
                             ((BATCH, 100), torch.float32), ((BATCH, 100), torch.int32)]
    targets = [str(n.target) for n in art.program.graph.nodes if n.op == "call_function"]
    assert targets.count("yolov6.greedy_nms.default") == 1


def test_artifact_keep_equals_live_serve(exported):
    _, _, model, art = exported
    images = _images()
    got = [t.numpy() for t in art.call(images)]
    want = [t.numpy() for t in end2end.make_end2end_fn(
        model, **SERVE, with_preprocess=True, half=False, device="cpu")(images)]
    num, boxes, scores, classes = got
    assert num.min() > 5
    np.testing.assert_array_equal(num, want[0])
    np.testing.assert_array_equal(classes, want[3])
    np.testing.assert_allclose(boxes, want[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(scores, want[2], rtol=0, atol=1e-6)


def test_artifact_matches_jax_serve(exported):
    jmodel, variables, _, art = exported
    images = _images(seed=4)
    num, boxes, scores, classes = [t.numpy() for t in art.call(images)]
    want = [np.asarray(a) for a in jax_make_end2end_fn(
        jmodel, variables, **SERVE, with_preprocess=True, half=False)(jnp.asarray(images))]
    assert want[0].min() > 5
    np.testing.assert_array_equal(num, want[0])
    np.testing.assert_array_equal(classes, want[3])
    np.testing.assert_allclose(boxes, want[1], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(scores, want[2], rtol=0, atol=1e-5)


def test_bf16_artifact_keeps_as_the_live_bf16_serve(tmp_path):
    """``--half``: bf16 weights and activations in the graph, decode and NMS
    in fp32, float input; on these images it keeps the live bf16 serve's
    boxes (autocast there) within the bf16 decode tolerance of PERF.md §2."""
    _, _, model = _pair("s", seed=12)
    path = str(tmp_path / "s_bf16.pt2")
    end2end.export_program(end2end.export_serve_module(model, **SERVE, half=True), BATCH,
                           (IMG, IMG), path, input_dtype=torch.float32)
    art = end2end.load_serving(path, device="cpu")
    assert art.in_specs == [((BATCH, IMG, IMG, 3), torch.float32)]
    images = _images(seed=5).astype(np.float32) / 255.0
    num, boxes, scores, classes = art.call(images)
    want = end2end.make_end2end_fn(model, **SERVE, half=True, device="cpu")(images)
    assert int(num.min()) > 5
    assert torch.equal(num, want[0]) and torch.equal(classes, want[3])
    torch.testing.assert_close(boxes, want[1], rtol=1e-2, atol=1.0)
    torch.testing.assert_close(scores, want[2], rtol=0, atol=1e-2)


@pytest.mark.parametrize("kw", [dict(platforms=("cpu",)), dict(shard_devices=2),
                                dict(weights={"w": 1})],
                         ids=["platforms", "shard_devices", "weights_as_args"])
def test_unported_export_options_raise(kw, tmp_path):
    module = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        end2end.export_program(module, 1, (8, 8), str(tmp_path / "x.pt2"), **kw)


def test_native_artifact_is_not_ported():
    with pytest.raises(NotImplementedError, match="do-not-port"):
        end2end.write_native_artifact(None, 1, (8, 8), "out")


def test_load_serving_needs_the_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        end2end.load_serving(str(tmp_path / "missing.pt2"), device="cpu")
