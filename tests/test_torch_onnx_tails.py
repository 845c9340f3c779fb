"""The port's ONNX files beyond the plain graph, against the JAX package's, on
the CPU: the protobuf reader on a JAX-written model, the end2end tails (ORT
``NonMaxSuppression``, TensorRT 8 ``EfficientNMS_TRT`` and 7
``BatchedNMSDynamic_TRT``), ``--dynamic-batch`` and fp16, and the loud error
for an ATen op with no mapping.

Small S at 64 px, 8 classes, from seeded JAX variables carried across by
``state_dict_from_jax``; JAX and the port export the same weights.

- ``onnx_proto``: the port's ``parse_model`` reads the JAX file back field
  for field as the JAX reader does (nodes, attributes, initializers, value
  infos, opsets).
- ORT tail: run through the numpy runner, ``num_dets`` equal to the JAX
  file's and the detections (boxes, scores, classes) within the fp32 graph
  tolerance, atol 5e-4 / rtol 1e-4.
- ``OnnxTorchModule`` runs ``NonMaxSuppression`` through the port's keep
  op: the selected indices equal the numpy runner's on random boxes (ties,
  inverted corners, centre-point boxes, with and without a score threshold
  and a cap a class), and the ORT-tail file through it equals the file
  through the numpy runner.
- TRT tails: the same plugin node (domain, attributes), the same node
  sequence after the prediction, and the same output names, types and
  shapes as the JAX file's.
- Dynamic batch, traced at batch 2 and run at 3 and 1: within atol 5e-4 /
  rtol 1e-4 of the port's forward.
- fp16: inputs and weights fp16, within the JAX CLI's fp16 tolerance (atol
  0.5 / rtol 0.05: the numpy runner accumulates in fp16).
"""

import functools

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.export.onnx_export import export_onnx as jax_export_onnx
from yolov6_tpu.export.onnx_proto import parse_model as jax_parse_model
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.export import onnx_proto as proto
from yolov6_tpu_torch.export.onnx_export import SENTINEL, export_onnx, make_dynamic_batch
from yolov6_tpu_torch.export.onnx_numpy import OnnxRunner
from yolov6_tpu_torch.export.onnx_proto import parse_model
from yolov6_tpu_torch.export.onnx_quant import encode_parsed, to_fp16
from yolov6_tpu_torch.export.torch_export import DeployForward, OnnxTorchModule, _TorchOps
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import random_jax_variables, small_s_config

IMG, NC = 64, 8
TOL = dict(atol=5e-4, rtol=1e-4)
NMS = dict(max_obj=30, iou_thres=0.45, score_thres=0.25)


@functools.lru_cache(maxsize=None)
def _pair():
    jmodel = jax_build_model(small_s_config(JaxConfig), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=31)
    model = build_model(small_s_config(Config), num_classes=NC, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)

    def jax_fwd(images):
        head_out, _ = jmodel.apply(variables, images, train=False)
        return jmodel.apply(variables, head_out, method=jmodel.decode)

    return DeployForward(model).eval(), jax_fwd


def _x(batch=2, seed=2):
    return np.random.default_rng(seed).uniform(0, 1, (batch, IMG, IMG, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _files(trt_version):
    fwd, jax_fwd = _pair()
    nms = dict(NMS, trt_version=trt_version)
    x = _x()
    return (export_onnx(fwd, (x,), input_names=["images"], nms=nms),
            jax_export_onnx(jax_fwd, (jnp.asarray(x),), input_names=["images"], nms=nms))


def _fields(m):
    return dict(
        head=(m.opset, dict(m.opsets), m.graph_name),
        nodes=[(n.op_type, n.inputs, n.outputs, n.name, n.domain, n.attrs) for n in m.nodes],
        inits={k: (v.dtype.str, v.shape, v.tobytes()) for k, v in m.initializers.items()},
        io=(m.inputs, m.outputs),
    )


def test_proto_reads_a_jax_written_model_field_for_field():
    _, jax_file = _files(None)
    mine, theirs = _fields(parse_model(jax_file)), _fields(jax_parse_model(jax_file))
    assert mine == theirs
    assert len(mine["nodes"]) > 50 and mine["inits"]
    # and the port's writer re-encodes it so that the JAX reader reads it equally
    assert _fields(jax_parse_model(encode_parsed(parse_model(jax_file)))) == theirs


def test_ort_tail_matches_jax_file():
    port, jax_file = _files(None)
    x = _x()
    got, want = OnnxRunner(port)(x), OnnxRunner(jax_file)(x)
    assert [n for n, _, _ in parse_model(port).outputs] == [
        "num_dets", "det_boxes", "det_scores", "det_classes"]
    np.testing.assert_array_equal(got[0], want[0])
    assert int(want[0].min()) > 2
    for i in range(x.shape[0]):
        n = int(want[0][i, 0])
        np.testing.assert_array_equal(got[3][i, :n], want[3][i, :n])
        np.testing.assert_allclose(got[1][i, :n], want[1][i, :n], **TOL)
        np.testing.assert_allclose(got[2][i, :n], want[2][i, :n], **TOL)


@pytest.mark.parametrize("center,score_th,max_out", [
    (0, None, 0), (0, 0.3, 5), (1, 0.3, 0), (1, None, 3)])
def test_nms_op_through_the_keep_matches_numpy_runner(center, score_th, max_out):
    rng = np.random.default_rng(7 + max_out)
    B, C, N = 2, 3, 200
    xy = rng.uniform(0, 64, (B, N, 2))
    wh = rng.uniform(-4, 24, (B, N, 2))  # some inverted corners
    boxes = np.concatenate([xy, xy + wh] if not center else [xy, np.abs(wh)], -1)
    scores = rng.choice(np.linspace(0.05, 1, 40), (B, C, N))  # many ties
    boxes, scores = boxes.astype(np.float32), scores.astype(np.float32)
    attrs = {"center_point_box": center}
    consts = [np.array([max_out], np.int64), np.array([0.45], np.float32)]
    if score_th is not None:
        consts.append(np.array([score_th], np.float32))
    want = OnnxRunner.op_NonMaxSuppression(None, attrs, boxes, scores, *consts)
    got = _TorchOps.op_NonMaxSuppression(attrs, torch.from_numpy(boxes),
                                         torch.from_numpy(scores), *consts)
    assert len(want) >= (B * C * max_out if max_out else 50)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ort_tail_through_onnx_torch_module_matches_numpy_runner():
    port, _ = _files(None)
    x = _x()
    want = OnnxRunner(port)(x)
    with torch.no_grad():
        got = [t.numpy() for t in OnnxTorchModule(port)(torch.from_numpy(x))]
    np.testing.assert_array_equal(got[0], want[0])
    for i in range(x.shape[0]):
        n = int(want[0][i, 0])
        np.testing.assert_array_equal(got[3][i, :n], want[3][i, :n])
        np.testing.assert_allclose(got[1][i, :n], want[1][i, :n], **TOL)
        np.testing.assert_allclose(got[2][i, :n], want[2][i, :n], **TOL)


def _tail(m, start_op):
    """The node sequence (op, domain, attributes) from the first ``start_op``
    of the prediction split on."""
    nodes = [(n.op_type, n.domain, n.attrs) for n in m.nodes]
    first = next(i for i, n in enumerate(nodes) if n[0] == start_op and i > len(nodes) // 2)
    return nodes[first:]


@pytest.mark.parametrize("trt_version", [7, 8])
def test_trt_tail_structure_matches_jax_file(trt_version):
    port, jax_file = _files(trt_version)
    mine, theirs = parse_model(port), jax_parse_model(jax_file)
    plugin = "EfficientNMS_TRT" if trt_version == 8 else "BatchedNMSDynamic_TRT"
    assert mine.opsets.get("TRT") == theirs.opsets.get("TRT") == 1
    (node,) = [n for n in mine.nodes if n.op_type == plugin]
    (jnode,) = [n for n in theirs.nodes if n.op_type == plugin]
    assert node.domain == jnode.domain == "TRT" and node.attrs == jnode.attrs
    assert _tail(mine, "Slice")[-8:] == _tail(theirs, "Slice")[-8:]
    assert mine.outputs == theirs.outputs


def test_dynamic_batch_runs_at_other_batches():
    fwd, _ = _pair()
    data = export_onnx(fwd, (_x(),), input_names=["images"], output_names=["outputs"],
                       dynamic_batch=True)
    m = parse_model(data)
    assert m.inputs[0][2][0] == SENTINEL
    make_dynamic_batch(m, SENTINEL)
    dyn = encode_parsed(m)
    parsed = parse_model(dyn)
    assert parsed.inputs[0][2][0] == "batch" and parsed.outputs[0][2][0] == "batch"
    runner = OnnxRunner(dyn)
    for b in (3, 1):
        x = _x(batch=b, seed=b)
        with torch.no_grad():
            want = fwd(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(runner(x)[0], want, **TOL)


def test_fp16_file():
    fwd, _ = _pair()
    x = _x(batch=1)
    data = export_onnx(fwd, (x,), input_names=["images"], output_names=["outputs"])
    m = parse_model(data)
    to_fp16(m)
    half = encode_parsed(m)
    assert len(half) < 0.6 * len(data)
    assert parse_model(half).inputs[0][1] == proto.FLOAT16
    got = OnnxRunner(half)(x.astype(np.float16))[0].astype(np.float32)
    with torch.no_grad():
        want = fwd(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=0.5, rtol=0.05)


def test_unsupported_aten_op_is_loud():
    class Cumsum(torch.nn.Module):
        def forward(self, x):
            return torch.cumsum(x, 0)

    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        export_onnx(Cumsum(), (torch.ones(4),))
