"""Minimal, dependency-free ONNX protobuf writer/reader.

A copy of yolov6_tpu/export/onnx_proto.py, framework-free.

The ``onnx`` package is not installed in this environment, so this module
hand-encodes the protobuf wire format for the subset of onnx.proto needed to
serialize (and parse back) a model: ModelProto / GraphProto / NodeProto /
TensorProto / AttributeProto / ValueInfoProto. Field numbers follow the
public onnx.proto schema (github.com/onnx/onnx/blob/main/onnx/onnx.proto);
files written here load in stock ``onnx``/onnxruntime/TensorRT parsers.

Reference counterpart: deploy/ONNX/export_onnx.py (which delegates to
torch.onnx.export); here the serializer is part of the framework so export
works with zero vendor deps.

Wire format recap: each field is a varint key ``(field_number << 3) | wire
type`` followed by the payload. Wire types used: 0 = varint, 2 = length-
delimited (strings, bytes, sub-messages, packed repeated scalars).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# --- TensorProto.DataType (onnx.proto enum values) ---
FLOAT = 1
UINT8 = 2
INT8 = 3
UINT16 = 4
INT16 = 5
INT32 = 6
INT64 = 7
STRING = 8
BOOL = 9
FLOAT16 = 10
DOUBLE = 11
UINT32 = 12
UINT64 = 13
BFLOAT16 = 16

NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.uint32): UINT32,
    np.dtype(np.uint64): UINT64,
}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}

# --- AttributeProto.AttributeType ---
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


# ---------------------------------------------------------------- encoding

def _varint(n: int) -> bytes:
    if n < 0:  # protobuf encodes negative int64 as 10-byte varint
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(fieldno: int, wtype: int) -> bytes:
    return _varint((fieldno << 3) | wtype)


def _enc_varint(fieldno: int, value: int) -> bytes:
    return _key(fieldno, 0) + _varint(int(value))


def _enc_bytes(fieldno: int, data: bytes) -> bytes:
    return _key(fieldno, 2) + _varint(len(data)) + data


def _enc_str(fieldno: int, s: str) -> bytes:
    return _enc_bytes(fieldno, s.encode("utf-8"))


def _enc_packed_i64(fieldno: int, values) -> bytes:
    body = b"".join(_varint(int(v)) for v in values)
    return _enc_bytes(fieldno, body)


def _enc_float(fieldno: int, value: float) -> bytes:
    return _key(fieldno, 5) + struct.pack("<f", value)


def _enc_packed_f32(fieldno: int, values) -> bytes:
    return _enc_bytes(fieldno, struct.pack(f"<{len(values)}f", *values))


# ---------------------------------------------------------------- messages

@dataclass
class Tensor:
    """TensorProto: dims=1, data_type=2, string_data=6, name=8, raw_data=9."""

    name: str
    array: np.ndarray

    def encode(self) -> bytes:
        a = np.ascontiguousarray(self.array)
        out = b"".join(_enc_varint(1, d) for d in a.shape)
        out += _enc_varint(2, NP_TO_ONNX[a.dtype])
        out += _enc_str(8, self.name)
        out += _enc_bytes(9, a.tobytes())
        return out


@dataclass
class Attribute:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    strings=9, type=20."""

    name: str
    value: Union[int, float, str, bytes, list, tuple, np.ndarray]

    def encode(self) -> bytes:
        out = _enc_str(1, self.name)
        v = self.value
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, (int, np.integer)):
            out += _enc_varint(3, v) + _enc_varint(20, ATTR_INT)
        elif isinstance(v, float):
            out += _enc_float(2, v) + _enc_varint(20, ATTR_FLOAT)
        elif isinstance(v, str):
            out += _enc_bytes(4, v.encode()) + _enc_varint(20, ATTR_STRING)
        elif isinstance(v, bytes):
            out += _enc_bytes(4, v) + _enc_varint(20, ATTR_STRING)
        elif isinstance(v, np.ndarray):
            out += _enc_bytes(5, Tensor("", v).encode()) + _enc_varint(20, ATTR_TENSOR)
        elif isinstance(v, (list, tuple)):
            if len(v) and isinstance(v[0], float):
                out += _enc_packed_f32(7, v) + _enc_varint(20, ATTR_FLOATS)
            elif len(v) and isinstance(v[0], (str, bytes)):
                for s in v:
                    out += _enc_bytes(9, s.encode() if isinstance(s, str) else s)
                out += _enc_varint(20, ATTR_STRINGS)
            else:
                out += _enc_packed_i64(8, v) + _enc_varint(20, ATTR_INTS)
        else:
            raise TypeError(f"unsupported attribute {self.name}: {type(v)}")
        return out


@dataclass
class Node:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5,
    domain=7 (custom domains, e.g. "TRT" for TensorRT plugin nodes)."""

    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, object] = field(default_factory=dict)
    domain: str = ""

    def encode(self) -> bytes:
        out = b"".join(_enc_str(1, s) for s in self.inputs)
        out += b"".join(_enc_str(2, s) for s in self.outputs)
        if self.name:
            out += _enc_str(3, self.name)
        out += _enc_str(4, self.op_type)
        for k, v in self.attrs.items():
            out += _enc_bytes(5, Attribute(k, v).encode())
        if self.domain:
            out += _enc_str(7, self.domain)
        return out


def _enc_value_info(name: str, elem_type: int, shape: Tuple[object, ...]) -> bytes:
    """ValueInfoProto{name=1, type=2}; TypeProto.tensor_type=1;
    Tensor{elem_type=1, shape=2}; TensorShapeProto.dim=1;
    Dimension{dim_value=1 | dim_param=2}."""
    dims = b""
    for d in shape:
        if isinstance(d, str):  # symbolic (dynamic) dimension
            dims += _enc_bytes(1, _enc_str(2, d))
        else:
            dims += _enc_bytes(1, _enc_varint(1, int(d)))
    tensor = _enc_varint(1, elem_type) + _enc_bytes(2, dims)
    typeproto = _enc_bytes(1, tensor)
    return _enc_str(1, name) + _enc_bytes(2, typeproto)


@dataclass
class ValueInfo:
    name: str
    elem_type: int
    shape: Tuple[object, ...]

    def encode(self) -> bytes:
        return _enc_value_info(self.name, self.elem_type, self.shape)


@dataclass
class Graph:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""

    name: str
    nodes: List[Node]
    inputs: List[ValueInfo]
    outputs: List[ValueInfo]
    initializers: List[Tensor]

    def encode(self) -> bytes:
        out = b"".join(_enc_bytes(1, n.encode()) for n in self.nodes)
        out += _enc_str(2, self.name)
        out += b"".join(_enc_bytes(5, t.encode()) for t in self.initializers)
        out += b"".join(_enc_bytes(11, v.encode()) for v in self.inputs)
        out += b"".join(_enc_bytes(12, v.encode()) for v in self.outputs)
        return out


def encode_model(
    graph: Graph,
    opset: int = 13,
    ir_version: int = 8,
    producer: str = "yolov6-tpu",
    doc: str = "",
    extra_opsets: Optional[Dict[str, int]] = None,
) -> bytes:
    """ModelProto: ir_version=1, producer_name=2, producer_version=3,
    doc_string=6, graph=7, opset_import=8 (OperatorSetId{domain=1,
    version=2}). ``extra_opsets`` adds custom-domain imports (e.g.
    {"TRT": 1} when the graph carries TensorRT plugin nodes)."""
    out = _enc_varint(1, ir_version)
    out += _enc_str(2, producer)
    out += _enc_str(3, "0.1")
    if doc:
        out += _enc_str(6, doc)
    out += _enc_bytes(7, graph.encode())
    out += _enc_bytes(8, _enc_str(1, "") + _enc_varint(2, opset))
    for dom, ver in (extra_opsets or {}).items():
        out += _enc_bytes(8, _enc_str(1, dom) + _enc_varint(2, ver))
    return out


# ---------------------------------------------------------------- decoding

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_fields(buf: bytes) -> Dict[int, list]:
    """Generic protobuf parse: field number -> list of raw payloads
    (ints for varint fields, bytes for length-delimited, 4/8-byte raw)."""
    fields: Dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        fno, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 2:
            n, pos = _read_varint(buf, pos)
            val = buf[pos : pos + n]
            pos += n
        elif wtype == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wtype == 1:
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        fields.setdefault(fno, []).append(val)
    return fields


def _parse_packed_i64(payloads: list) -> List[int]:
    out = []
    for payload in payloads:
        if isinstance(payload, int):  # unpacked encoding
            out.append(payload)
            continue
        pos = 0
        while pos < len(payload):
            v, pos = _read_varint(payload, pos)
            if v >= 1 << 63:
                v -= 1 << 64
            out.append(v)
    return out


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    f = parse_fields(buf)
    dims = _parse_packed_i64(f.get(1, []))
    dtype = ONNX_TO_NP[f[2][0]]
    name = f.get(8, [b""])[0].decode()
    if 9 in f:  # raw_data (what this writer emits)
        arr = np.frombuffer(f[9][0], dtype=dtype).reshape(dims)
    elif 4 in f:  # packed float_data (foreign writers)
        vals: list = []
        for payload in f[4]:
            if isinstance(payload, bytes):  # packed (wire type 2)
                vals += struct.unpack(f"<{len(payload) // 4}f", payload)
            else:  # unpacked 32-bit (wire type 5) arrives as 4 raw bytes
                vals.append(struct.unpack("<f", payload)[0])
        arr = np.array(vals, np.float32).astype(dtype).reshape(dims)
    elif 7 in f:  # int64_data
        arr = np.array(_parse_packed_i64(f[7]), np.int64).astype(dtype).reshape(dims)
    else:
        arr = np.zeros(dims, dtype)
    return name, arr


def parse_attribute(buf: bytes):
    f = parse_fields(buf)
    name = f[1][0].decode()
    atype = f.get(20, [0])[0]
    if atype == ATTR_INT:
        v = f[3][0]
        if v >= 1 << 63:
            v -= 1 << 64
        return name, v
    if atype == ATTR_FLOAT:
        return name, struct.unpack("<f", f[2][0])[0]
    if atype == ATTR_STRING:
        return name, f[4][0].decode()
    if atype == ATTR_TENSOR:
        return name, parse_tensor(f[5][0])[1]
    if atype == ATTR_INTS:
        return name, _parse_packed_i64(f.get(8, []))
    if atype == ATTR_FLOATS:
        raw = f.get(7, [])
        vals = []
        for payload in raw:
            if isinstance(payload, bytes) and len(payload) % 4 == 0 and len(payload) > 4:
                vals += list(struct.unpack(f"<{len(payload) // 4}f", payload))
            else:
                vals.append(struct.unpack("<f", payload)[0])
        return name, vals
    if atype == ATTR_STRINGS:
        return name, [s.decode() for s in f.get(9, [])]
    raise ValueError(f"unsupported attribute type {atype} for {name}")


@dataclass
class ParsedNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str
    attrs: Dict[str, object]
    domain: str = ""


@dataclass
class ParsedModel:
    graph_name: str
    opset: int
    nodes: List[ParsedNode]
    inputs: List[Tuple[str, int, Tuple[object, ...]]]
    outputs: List[Tuple[str, int, Tuple[object, ...]]]
    initializers: Dict[str, np.ndarray]
    opsets: Dict[str, int] = field(default_factory=dict)  # all domains


def _parse_value_info(buf: bytes) -> Tuple[str, int, Tuple[object, ...]]:
    f = parse_fields(buf)
    name = f[1][0].decode()
    tf = parse_fields(f[2][0])
    tens = parse_fields(tf[1][0])
    elem = tens.get(1, [0])[0]
    dims: List[object] = []
    if 2 in tens:
        shape = parse_fields(tens[2][0])
        for d in shape.get(1, []):
            df = parse_fields(d)
            if 1 in df:
                dims.append(df[1][0])
            elif 2 in df:
                dims.append(df[2][0].decode())
    return name, elem, tuple(dims)


def parse_model(buf: bytes) -> ParsedModel:
    f = parse_fields(buf)
    opset = 0
    opsets: Dict[str, int] = {}
    for op in f.get(8, []):
        of = parse_fields(op)
        dom = of.get(1, [b""])[0]
        opsets[dom.decode()] = of.get(2, [0])[0]
        if dom in (b"", b"ai.onnx"):
            opset = of.get(2, [0])[0]
    g = parse_fields(f[7][0])
    nodes = []
    for nb in g.get(1, []):
        nf = parse_fields(nb)
        nodes.append(
            ParsedNode(
                op_type=nf[4][0].decode(),
                inputs=[s.decode() for s in nf.get(1, [])],
                outputs=[s.decode() for s in nf.get(2, [])],
                name=nf.get(3, [b""])[0].decode(),
                attrs=dict(parse_attribute(a) for a in nf.get(5, [])),
                domain=nf.get(7, [b""])[0].decode(),
            )
        )
    inits = dict(parse_tensor(t) for t in g.get(5, []))
    return ParsedModel(
        graph_name=g.get(2, [b""])[0].decode(),
        opset=opset,
        nodes=nodes,
        inputs=[_parse_value_info(v) for v in g.get(11, [])],
        outputs=[_parse_value_info(v) for v in g.get(12, [])],
        initializers=inits,
        opsets=opsets,
    )
