"""INT8 QDQ ONNX export (a copy of yolov6_tpu/export/onnx_quant.py): rewrite
fake-quant math into QuantizeLinear / DequantizeLinear nodes (the reference's
QAT "QDQ surgery" analog — reference: tools/qat/qat_export.py + deploy/ONNX
int8 flow, where TensorRT consumes explicit QDQ pairs to place int8 kernels).

Pipeline over a serialized model (bytes -> bytes), applied after the
ATen->ONNX conversion of a quant-mode deploy graph (the fake-quant math of
``quant_mode`` is traced in-graph; quant/fake_quant.py):

1. ``fold_constants`` — evaluate nodes whose inputs are all initializers
   with the numpy interpreter ops; the scale chains
   ``Div(Max(amax, eps), qmax)`` and gate preds ``Greater(amax, 0)``
   collapse to scalar initializers.
2. ``rewrite_qdq`` — pattern-match the exact emission of
   ``fake_quant`` (quant/fake_quant.py:64-70):
   ``Where(pred, Mul(Round(Min(Max(Div(x, s), -qmax-1), qmax)), s), x)``
   and replace with ``QuantizeLinear(x, s, zp=0i8) -> DequantizeLinear``.
   The math is bit-identical: integer clip bounds commute with
   round-to-nearest-even saturation. A const-False pred (skipped /
   sensitive layer, amax==0) folds to a passthrough.
3. ``quantize_conv_weights`` — store every Conv kernel as an int8
   initializer + per-output-channel DequantizeLinear (axis=0, OIHW). For
   kernels already fake-quantized by PTQ (quant/ptq.quantize_variables)
   the int8 grid is recovered exactly.

Round-trip parity vs the port's fake-quant graph is tested in
tests/test_torch_onnx_qdq.py with the numpy interpreter.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from yolov6_tpu_torch.export import onnx_proto as op
from yolov6_tpu_torch.export.onnx_numpy import OnnxRunner
from yolov6_tpu_torch.export.onnx_proto import ParsedModel, ParsedNode, parse_model

_OPS = OnnxRunner(ParsedModel("", 13, [], [], [], {}))


# ------------------------------------------------------------------ passes

def fold_constants(
    m: ParsedModel, max_bytes: int = 1 << 20, skip_ops=("Expand",)
) -> None:
    """Evaluate nodes with all-initializer inputs in place (skips outputs
    larger than ``max_bytes`` and graph outputs, which must stay nodes).
    ``Expand`` is never folded: it broadcasts along the batch dimension, so
    folding would bloat the artifact batch-fold and bake the batch size in
    (breaking a later make_dynamic_batch rewrite)."""
    inits = m.initializers
    graph_outputs = {n for n, _, _ in m.outputs}
    kept: List[ParsedNode] = []
    for node in m.nodes:
        foldable = (
            node.inputs
            and node.op_type not in skip_ops
            and all((not i) or i in inits for i in node.inputs)
            and not any(o in graph_outputs for o in node.outputs)
        )
        fn = getattr(_OPS, f"op_{node.op_type}", None) if foldable else None
        if fn is not None:
            try:
                outs = fn(node.attrs, *[inits[i] if i else None for i in node.inputs])
            except Exception:
                kept.append(node)
                continue
            if not isinstance(outs, tuple):
                outs = (outs,)
            if sum(np.asarray(o).nbytes for o in outs) <= max_bytes:
                for name, val in zip(node.outputs, outs):
                    inits[name] = np.asarray(val)
                continue
        kept.append(node)
    m.nodes = kept


def _rebind(m: ParsedModel, alias: Dict[str, str]) -> None:
    def res(n: str) -> str:
        seen = set()
        while n in alias and n not in seen:
            seen.add(n)
            n = alias[n]
        return n

    for node in m.nodes:
        node.inputs = [res(i) for i in node.inputs]
    m.outputs = [(res(n), et, sh) for n, et, sh in m.outputs]


def rewrite_qdq(m: ParsedModel, num_bits: int = 8) -> int:
    """Replace fake-quant chains with QDQ pairs; returns #rewritten."""
    inits = m.initializers
    prod: Dict[str, ParsedNode] = {}
    for node in m.nodes:
        for o in node.outputs:
            prod[o] = node
    qmax = 2.0 ** (num_bits - 1) - 1

    def const_scalar(name: str) -> Optional[float]:
        v = inits.get(name)
        if v is not None and v.size == 1:
            return float(np.asarray(v).reshape(-1)[0])
        return None

    def split_const(node: ParsedNode):
        """(const_name, other_input) for a binary node with one init input."""
        a, b = node.inputs[0], node.inputs[1]
        if a in inits and const_scalar(a) is not None:
            return a, b
        if b in inits and const_scalar(b) is not None:
            return b, a
        return None, None

    zp_name = None
    alias: Dict[str, str] = {}
    dead: set = set()
    new_nodes: List[ParsedNode] = []
    n_rewritten = 0

    for node in m.nodes:
        if node.op_type != "Where" or node.inputs[0] not in inits:
            continue
        pred = inits[node.inputs[0]]
        if pred.size != 1:
            continue
        x_orig = node.inputs[2]
        if not bool(pred.reshape(-1)[0]):
            alias[node.outputs[0]] = x_orig  # skipped layer: passthrough
            dead.add(id(node))
            continue
        mul = prod.get(node.inputs[1])
        if mul is None or mul.op_type != "Mul":
            continue
        s_name, r_out = split_const(mul)
        if s_name is None:
            continue
        rnd = prod.get(r_out)
        if rnd is None or rnd.op_type != "Round":
            continue
        mn = prod.get(rnd.inputs[0])
        if mn is None:
            continue
        if mn.op_type == "Clip":
            # the exporter's canonical clamp form: Clip(Div(x,s), lo, hi)
            if len(mn.inputs) < 3 or not mn.inputs[1] or not mn.inputs[2]:
                continue
            lo_name, hi_name = mn.inputs[1], mn.inputs[2]
            div = prod.get(mn.inputs[0])
            if div is None or div.op_type != "Div":
                continue
        elif mn.op_type == "Min":
            # legacy eltwise form: Min(Max(Div(x,s), lo), hi)
            hi_name, mx_out = split_const(mn)
            mx = prod.get(mx_out) if mx_out else None
            if hi_name is None or mx is None or mx.op_type != "Max":
                continue
            lo_name, div_out = split_const(mx)
            div = prod.get(div_out) if div_out else None
            if lo_name is None or div is None or div.op_type != "Div":
                continue
        else:
            continue
        if const_scalar(hi_name) != qmax or const_scalar(lo_name) != -qmax - 1:
            continue
        if div.inputs[0] != x_orig or div.inputs[1] != s_name:
            # scale consts are deduped by value during folding; also accept
            # a different name with the same value
            s2 = const_scalar(div.inputs[1])
            if div.inputs[0] != x_orig or s2 is None or s2 != const_scalar(s_name):
                continue
        if zp_name is None:
            zp_name = "qdq_zero_point"
            inits[zp_name] = np.zeros((), np.int8)
        scale = np.asarray(const_scalar(s_name), np.float32)
        s32 = f"{s_name}_f32"
        if s32 not in inits:
            inits[s32] = scale
        q_out = node.outputs[0] + "_q"
        new_nodes.append(
            ParsedNode("QuantizeLinear", [x_orig, s32, zp_name], [q_out],
                       name=q_out, attrs={})
        )
        new_nodes.append(
            ParsedNode("DequantizeLinear", [q_out, s32, zp_name],
                       [node.outputs[0]], name=node.outputs[0] + "_dq", attrs={})
        )
        dead.add(id(node))
        n_rewritten += 1

    if not (new_nodes or alias):
        return 0
    # splice: each QDQ pair replaces its Where node in place (graph order
    # stays topological); matched arithmetic chains die in the prune
    out: List[ParsedNode] = []
    by_where = {n.outputs[0]: i for i, n in enumerate(new_nodes) if n.op_type == "DequantizeLinear"}
    for node in m.nodes:
        if id(node) in dead:
            if node.outputs[0] in by_where:
                i = by_where[node.outputs[0]]
                out.append(new_nodes[i - 1])  # QuantizeLinear
                out.append(new_nodes[i])
            continue
        out.append(node)
    m.nodes = out
    _rebind(m, alias)
    return n_rewritten


def quantize_conv_weights(m: ParsedModel, num_bits: int = 8) -> int:
    """Fold every Conv kernel initializer to int8 + per-channel
    DequantizeLinear (OIHW axis=0). Exact for PTQ-pre-quantized kernels."""
    inits = m.initializers
    qmax = 2.0 ** (num_bits - 1) - 1
    out: List[ParsedNode] = []
    n_quantized = 0
    for node in m.nodes:
        if node.op_type == "Conv" and node.inputs[1] in inits:
            w = inits.pop(node.inputs[1])
            amax = np.abs(w).reshape(w.shape[0], -1).max(axis=1)
            scale = (np.maximum(amax, 1e-12) / qmax).astype(np.float32)
            wq = np.clip(
                np.round(w / scale[:, None, None, None]), -qmax - 1, qmax
            ).astype(np.int8)
            base = node.inputs[1]
            inits[base + "_i8"] = wq
            inits[base + "_scale"] = scale
            inits[base + "_zp"] = np.zeros((w.shape[0],), np.int8)
            dq = base + "_dq"
            out.append(
                ParsedNode(
                    "DequantizeLinear",
                    [base + "_i8", base + "_scale", base + "_zp"],
                    [dq], name=dq, attrs={"axis": 0},
                )
            )
            node.inputs[1] = dq
            n_quantized += 1
        out.append(node)
    m.nodes = out
    return n_quantized


def prune_dead(m: ParsedModel) -> None:
    live = {n for n, _, _ in m.outputs}
    for node in reversed(m.nodes):
        if any(o in live for o in node.outputs):
            live.update(node.inputs)
    m.nodes = [n for n in m.nodes if any(o in live for o in n.outputs)]
    m.initializers = {k: v for k, v in m.initializers.items() if k in live}


def to_fp16(m: ParsedModel) -> None:
    """Convert a float32 graph to float16 in place (the reference's --half
    ONNX export, deploy/ONNX/export_onnx.py: model.half()): fp32
    initializers, graph IO, and Cast targets become fp16. Consumers (TRT,
    ORT) run the same ops in half precision."""
    f32 = op.NP_TO_ONNX[np.dtype(np.float32)]
    f16 = op.NP_TO_ONNX[np.dtype(np.float16)]
    for name, arr in list(m.initializers.items()):
        if arr.dtype == np.float32:
            m.initializers[name] = arr.astype(np.float16)
    for node in m.nodes:
        if node.op_type == "Cast" and node.attrs.get("to") == f32:
            node.attrs["to"] = f16
    m.inputs = [(n, f16 if et == f32 else et, sh) for n, et, sh in m.inputs]
    m.outputs = [(n, f16 if et == f32 else et, sh) for n, et, sh in m.outputs]


# -------------------------------------------- QDQ removal + TRT calib cache

def remove_qdq(model_bytes: bytes):
    """Strip QDQ pairs from a QDQ graph, collecting activation scales.

    The TensorRT implicit-int8 deployment path consumes a plain fp32 ONNX +
    a calibration cache instead of explicit QDQ nodes (reference:
    tools/qat/onnx_utils.py:147-272 onnx_remove_qdqnode). Returns
    ``(plain_model_bytes, activation_map)`` where activation_map maps
    tensor name -> big-endian float32 hex of its scale, max-merged when a
    tensor is quantized more than once (reference :215-220). Weight
    DequantizeLinear nodes are folded by de-quantizing the int8 initializer
    back to fp32 (our QDQ export stores kernels as int8 payloads; the
    reference keeps fp32 weights so it can simply drop the nodes).
    """
    import struct

    m = parse_model(model_bytes)
    inits = m.initializers
    alias: Dict[str, str] = {}
    activation_map: Dict[str, str] = {}
    kept: List[ParsedNode] = []
    for node in m.nodes:
        if node.op_type == "QuantizeLinear":
            x, s = node.inputs[0], node.inputs[1]
            sval = inits.get(s)
            if sval is not None and sval.size == 1 and x not in inits:
                val = float(np.asarray(sval).reshape(-1)[0])
                if x in activation_map:
                    old = struct.unpack("!f", bytes.fromhex(activation_map[x]))[0]
                    val = max(val, old)
                activation_map[x] = struct.pack(">f", np.float32(val)).hex()
                alias[node.outputs[0]] = x
                continue
        elif node.op_type == "DequantizeLinear":
            inp = node.inputs[0]
            if inp in inits:  # int8 weight: fold the dequant into the init
                w = inits[inp].astype(np.float32)
                scale = np.asarray(inits[node.inputs[1]], np.float32)
                zp = (np.asarray(inits[node.inputs[2]], np.float32)
                      if len(node.inputs) > 2 and node.inputs[2] else 0.0)
                if scale.ndim == 1:  # per-channel along attrs axis
                    ax = int(node.attrs.get("axis", 0))
                    shape = [1] * w.ndim
                    shape[ax] = -1
                    scale = scale.reshape(shape)
                    zp = np.asarray(zp).reshape(shape) if np.ndim(zp) else zp
                inits[node.outputs[0]] = (w - zp) * scale
                continue
            if inp not in alias:
                # The paired QuantizeLinear was NOT removed (non-scalar or
                # computed scale): aliasing this DQ away would silently route
                # an int8 tensor into fp32 consumers. Fail loudly instead.
                raise ValueError(
                    f"remove_qdq: DequantizeLinear '{node.name}' consumes "
                    f"'{inp}' whose QuantizeLinear was kept (non-scalar or "
                    "non-initializer scale) — unhandled QDQ pattern"
                )
            alias[node.outputs[0]] = inp
            continue
        kept.append(node)
    m.nodes = kept
    _rebind(m, alias)
    prune_dead(m)
    return (
        encode_parsed(m, opset=m.opset or 13, doc="QDQ removed (implicit int8)"),
        activation_map,
    )


def save_calib_cache_file(cache_file: str, activation_map: Dict[str, str],
                          headline: str = "TRT-8XXX-EntropyCalibration2\n") -> None:
    """Write a TensorRT calibration cache: header line, then one
    ``tensor_name: <be-float32-hex>`` row per activation (the exact layout
    IInt8Calibrator.read_calibration_cache consumes; reference
    tools/qat/onnx_utils.py:274-278)."""
    with open(cache_file, "w") as f:
        f.write(headline)
        for k, v in activation_map.items():
            f.write(f"{k}: {v}\n")


# --------------------------------------------------------------- re-encode

def encode_parsed(m: ParsedModel, opset: int = 13, doc: str = "") -> bytes:
    nodes = [
        op.Node(n.op_type, list(n.inputs), list(n.outputs), n.name, dict(n.attrs),
                domain=n.domain)
        for n in m.nodes
    ]
    graph = op.Graph(
        name=m.graph_name or "yolov6",
        nodes=nodes,
        inputs=[op.ValueInfo(n, et, sh) for n, et, sh in m.inputs],
        outputs=[op.ValueInfo(n, et, sh) for n, et, sh in m.outputs],
        initializers=[op.Tensor(k, v) for k, v in m.initializers.items()],
    )
    extra = {d: v for d, v in m.opsets.items() if d not in ("", "ai.onnx")}
    return op.encode_model(graph, opset=opset, doc=doc, extra_opsets=extra or None)


def to_qdq(model_bytes: bytes, num_bits: int = 8, doc: str = "") -> bytes:
    """Full pipeline: fold -> QDQ rewrite -> int8 weights -> prune -> encode."""
    m = parse_model(model_bytes)
    fold_constants(m)
    n_act = rewrite_qdq(m, num_bits)
    n_w = quantize_conv_weights(m, num_bits)
    prune_dead(m)
    if n_act == 0:
        raise ValueError(
            "no fake-quant chains found — trace the model with quant mode "
            "enabled (set_quant_mode) and a calibrated 'quant' collection"
        )
    return encode_parsed(m, opset=m.opset or 13,
                         doc=doc or f"QDQ int8 ({n_act} act, {n_w} weight)")
