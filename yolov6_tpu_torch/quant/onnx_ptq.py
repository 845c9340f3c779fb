"""ONNX-level post-training quantization — the PPQ-driver analog.

A copy of yolov6_tpu/quant/onnx_ptq.py, framework-free.

The reference drives the third-party PPQ quantizer over an exported ONNX
(reference: tools/quantization/ppq/ProgramEntrance.py:33-189 — minmax
RuntimeCalibrationPass over a calib dataset, TRT_INT8 QDQ export, plus a
qparams JSON consumed by write_qparams_onnx2trt.py:22-44 to set TRT
per-tensor dynamic ranges). PPQ is not installable here and this framework
has its own ONNX stack, so the same capability is implemented natively:

* ``calibrate_onnx`` — run calibration batches through the numpy ONNX
  interpreter (export/onnx_numpy.py) with a per-node observer, collecting
  per-tensor minmax amax (the RuntimeCalibrationPass analog).
* ``write_qparams_json`` — emit the PPQ ``Quantized.json`` contract:
  ``{"act_quant_info": {tensor_name: amax}}`` — byte-compatible with the
  reference's onnx2trt dynamic-range writer.
* ``insert_activation_qdq`` — place QuantizeLinear/DequantizeLinear pairs
  on every Conv data input using the observed scales, and int8-fold conv
  weights (ParameterQuantizePass + TRT_INT8 export analog). The result is
  a standard explicit-QDQ int8 ONNX.
* ``build_trt_engine_with_qparams`` — the write_qparams_onnx2trt.py mirror,
  gated on a ``tensorrt`` install (absent here; unit-tested with a fake
  vendor module like the OpenVINO/trtexec shims).

Unlike the fake-quant path (quant/ptq.py + export/onnx_quant.py, which
needs a checkpoint traced in quant mode), this pipeline quantizes ANY
exported ONNX artifact after the fact — the same role PPQ plays upstream.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from yolov6_tpu_torch.export.onnx_numpy import OnnxRunner
from yolov6_tpu_torch.export.onnx_proto import ParsedModel, ParsedNode, parse_model
from yolov6_tpu_torch.export.onnx_quant import (
    encode_parsed,
    prune_dead,
    quantize_conv_weights,
)


def calibrate_onnx(
    model_bytes: bytes,
    batches: Iterable[np.ndarray],
    max_steps: int = 32,
    progress: Optional[Callable[[int], None]] = None,
) -> Dict[str, float]:
    """Minmax activation calibration: run up to ``max_steps`` batches and
    record per-tensor ``amax = max(|x|)`` for every float intermediate
    (PPQ RuntimeCalibrationPass with observer_algorithm='minmax';
    reference ProgramEntrance.py:141-158)."""
    runner = OnnxRunner(model_bytes)
    amax: Dict[str, float] = {}
    # graph inputs are activations too (TRT sets their range from the JSON).
    # Each calibration step feeds ONE array, so a multi-input graph would
    # both fail at runner(batch) and record the wrong per-input ranges here.
    input_names = list(runner.input_names)
    if len(input_names) != 1:
        raise ValueError(
            f"calibrate_onnx supports single-input models, got inputs "
            f"{input_names}"
        )

    def observe(name, val, node):
        a = np.asarray(val)
        if a.dtype.kind != "f" or a.size == 0:
            return
        m = float(np.abs(a).max())
        if m > amax.get(name, 0.0):
            amax[name] = m

    runner.observer = observe
    for step, batch in enumerate(batches):
        if step >= max_steps:
            break
        batch = np.asarray(batch)
        for name in input_names:
            m = float(np.abs(batch).max()) if batch.dtype.kind == "f" else 0.0
            if m > amax.get(name, 0.0):
                amax[name] = m
        runner(batch)
        if progress is not None:
            progress(step)
    runner.observer = None
    if not amax:
        raise ValueError("calibration saw no float activations")
    return amax


def write_qparams_json(path: str, act_amax: Dict[str, float]) -> None:
    """PPQ Quantized.json contract: {"act_quant_info": {name: amax}}
    (consumed by the reference write_qparams_onnx2trt.py:22-44, which takes
    abs() and sets TRT dynamic_range = (-amax, +amax))."""
    with open(path, "w") as f:
        json.dump({"act_quant_info": {k: float(v) for k, v in act_amax.items()}},
                  f, indent=2)


def insert_activation_qdq(
    model_bytes: bytes,
    act_amax: Dict[str, float],
    num_bits: int = 8,
) -> bytes:
    """Explicit-QDQ int8 export: QDQ pair on every Conv data input (scale
    from the observed amax) + int8 per-channel conv weights. Returns the
    serialized quantized model (the PPQ TRT_INT8 GraphExporter analog)."""
    m = parse_model(model_bytes)
    inits = m.initializers
    # The emitted QuantizeLinear stores int8 (saturates at ±127) regardless
    # of num_bits, so sub-8-bit here would coarsen the grid without
    # narrowing the clipping range — not true sub-8-bit quantization.
    if num_bits != 8:
        raise ValueError("insert_activation_qdq supports num_bits=8 only "
                         "(QDQ zero-point/storage is int8)")
    qmax = 2.0 ** (num_bits - 1) - 1
    zp_name = "qdq_zero_point"
    if zp_name not in inits:
        inits[zp_name] = np.zeros((), np.int8)

    qdq_cache: Dict[str, str] = {}  # tensor -> its dequantized alias
    out_nodes = []
    n_act = 0
    for node in m.nodes:
        if node.op_type == "Conv" and node.inputs[0] not in inits:
            x = node.inputs[0]
            if x in qdq_cache:
                node.inputs[0] = qdq_cache[x]
            elif x in act_amax and act_amax[x] > 0.0:
                s_name = f"{x}_qscale"
                inits[s_name] = np.float32(act_amax[x] / qmax)
                q, dq = f"{x}_q", f"{x}_dq"
                out_nodes.append(ParsedNode(
                    "QuantizeLinear", [x, s_name, zp_name], [q], name=q, attrs={}))
                out_nodes.append(ParsedNode(
                    "DequantizeLinear", [q, s_name, zp_name], [dq], name=dq, attrs={}))
                qdq_cache[x] = dq
                node.inputs[0] = dq
                n_act += 1
        out_nodes.append(node)
    m.nodes = out_nodes
    if n_act == 0:
        raise ValueError(
            "no Conv inputs matched the calibration map — was the model "
            "calibrated with calibrate_onnx on the same graph?"
        )
    quantize_conv_weights(m, num_bits)
    prune_dead(m)
    return encode_parsed(m, opset=m.opset or 13,
                         doc=f"onnx-level PTQ int8 ({n_act} act QDQ)")


def build_trt_engine_with_qparams(
    onnx_path: str, qparams_json: str, engine_path: str,
    max_workspace_gb: int = 1,
) -> str:
    """Mirror of the reference write_qparams_onnx2trt.py:46-94: parse the
    (plain fp32) ONNX with TensorRT, set per-tensor dynamic ranges from the
    qparams JSON, and build an int8 engine. Requires the ``tensorrt``
    python package (absent in this environment; exercised with a fake
    vendor module in tests/test_vendor_shims.py style)."""
    try:
        import tensorrt as trt  # vendor-gated
    except ImportError as e:  # pragma: no cover - exercised via fake vendor
        raise RuntimeError(
            "tensorrt is not installed — build the engine on a machine with "
            "TRT: python -c \"from yolov6_tpu_torch.quant.onnx_ptq import "
            "build_trt_engine_with_qparams as b; b(...)\""
        ) from e

    with open(qparams_json) as f:
        act_quant = json.load(f)["act_quant_info"]

    logger = trt.Logger()
    builder = trt.Builder(logger)
    network = builder.create_network(
        1 << int(trt.NetworkDefinitionCreationFlag.EXPLICIT_BATCH))
    parser = trt.OnnxParser(network, logger)
    with open(onnx_path, "rb") as f:
        if not parser.parse(f.read()):
            raise RuntimeError(
                f"TRT failed to parse {onnx_path}: {parser.get_error(0)}")

    config = builder.create_builder_config()
    config.max_workspace_size = max_workspace_gb << 30
    config.set_flag(trt.BuilderFlag.INT8)

    def set_range(tensor):
        if tensor.name in act_quant:
            a = abs(float(act_quant[tensor.name]))
            tensor.dynamic_range = (-a, a)
            return 1
        return 0

    n_set = sum(set_range(network.get_input(i))
                for i in range(network.num_inputs))
    for i in range(network.num_layers):
        layer = network.get_layer(i)
        for j in range(layer.num_outputs):
            n_set += set_range(layer.get_output(j))

    engine = builder.build_engine(network, config)
    if engine is None:
        raise RuntimeError("TRT engine build failed")
    with open(engine_path, "wb") as f:
        f.write(engine.serialize())
    return f"int8 engine built ({n_set} dynamic ranges set) -> {engine_path}"
