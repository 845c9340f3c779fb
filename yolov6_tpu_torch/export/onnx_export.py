"""torch.export (core ATen) -> ONNX graph converter (port of
yolov6_tpu/export/onnx_export.py, whose converter walks a jaxpr).

Exports a deploy function of the port (fwd+decode of every model family,
static shapes, or a batch made dynamic) to an ONNX file with no vendor
dependency: the protobuf is hand-written by export/onnx_proto.py, a copy of
the JAX package's, as ``torch.onnx.export`` needs the absent ``onnx``
package.

Design notes:
- ``torch.export`` traces the function; ``run_decompositions()`` lowers it
  to core ATen, and each ATen op maps to opset-13 ONNX ops through the
  ``_Builder`` copied from the JAX converter. An op with no mapping raises
  with its name, so gaps are loud.
- Torch is NCHW like ONNX's Conv and MaxPool, so no boundary transposes are
  needed; the exported function takes NHWC images (the JAX contract) and
  its first ``permute`` becomes the graph's one Transpose.
- Nodes whose tensor inputs are all constants (weights, anchors, scales,
  ``full``/``arange``) are evaluated with torch at conversion time and
  become initializers; a conv's weight and bias stay its inputs.
- The ``Transpose`` block's 2x2 stride-2 transposed conv is emitted as the
  JAX package computes it: a MatMul over channels and a depth-to-space
  (Reshape, Transpose, Reshape), plus the bias.
- A batch made dynamic is traced symbolically and written with a prime
  sentinel in its place; ``make_dynamic_batch`` (copied) rewrites it.
- The end2end tails (ORT ``NonMaxSuppression``, TensorRT's
  ``EfficientNMS_TRT`` and ``BatchedNMSDynamic_TRT``), ``make_dynamic_batch``
  and ``_prune_dead`` are copies of the JAX converter's.

Execution parity against the torch function is tested with the numpy
interpreter (export/onnx_numpy.py, tests/test_torch_onnx_export.py).
"""

from __future__ import annotations

import operator
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from yolov6_tpu_torch.export import onnx_proto as op

SENTINEL = 509  # a dynamic batch is written as this prime (make_dynamic_batch)


class _Builder:
    def __init__(self):
        self.nodes: List[op.Node] = []
        self.initializers: Dict[str, op.Tensor] = {}
        self._n = 0
        self._const_cache: Dict[tuple, str] = {}
        self.produced_by: Dict[str, op.Node] = {}
        self.n_consumers: Dict[str, int] = {}
        # the port's converter: each converted tensor's shape, and whether
        # its ATen value has one consumer (the Clip composition's test)
        self.shapes: Dict[str, tuple] = {}
        self.single_use: Dict[str, bool] = {}

    def name(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def emit(self, op_type: str, inputs: Sequence[str], n_out: int = 1,
             hint: Optional[str] = None, domain: str = "", **attrs) -> List[str]:
        outs = [self.name(hint or op_type.lower()) for _ in range(n_out)]
        node = op.Node(op_type, list(inputs), outs, name=outs[0], attrs=attrs,
                       domain=domain)
        self.nodes.append(node)
        for i in inputs:
            self.n_consumers[i] = self.n_consumers.get(i, 0) + 1
        for o in outs:
            self.produced_by[o] = node
        return outs

    def const(self, arr: np.ndarray, hint: str = "c") -> str:
        arr = np.asarray(arr)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        key = (str(arr.dtype), arr.shape, arr.tobytes())
        if key in self._const_cache:
            return self._const_cache[key]
        name = self.name(hint)
        self.initializers[name] = op.Tensor(name, arr)
        self._const_cache[key] = name
        return name

    def transpose(self, x: str, perm: Sequence[int]) -> str:
        """Emit Transpose, cancelling an immediately-preceding inverse."""
        perm = list(int(p) for p in perm)
        if perm == sorted(perm):
            return x
        prev = self.produced_by.get(x)
        if prev is not None and prev.op_type == "Transpose":
            prev_perm = list(prev.attrs["perm"])
            composed = [prev_perm[p] for p in perm]
            if composed == sorted(composed):
                return prev.inputs[0]
            return self.emit("Transpose", [prev.inputs[0]], perm=composed)[0]
        return self.emit("Transpose", [x], perm=perm)[0]

    def reshape(self, x: str, shape: Sequence[int]) -> str:
        s = self.const(np.asarray(shape, np.int64), "shape")
        return self.emit("Reshape", [x, s])[0]


_ONNX_FLOAT = {torch.float32, torch.bfloat16, torch.float16, torch.float64}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """A torch dtype as the graph's numpy dtype: floats ship as fp32 (as the
    JAX converter ships bf16 and float64)."""
    if dtype in _ONNX_FLOAT:
        return np.dtype(np.float32)
    return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)


def _to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in _ONNX_FLOAT:
        t = t.float()
    return t.numpy()


class _Const:
    """A compile-time constant tensor of the traced graph."""

    def __init__(self, value: torch.Tensor):
        self.value = value


def _has_sym(val) -> bool:
    return isinstance(val, torch.Tensor) and any(
        not isinstance(s, int) for s in val.shape)


class _Converter:
    """Walks an exported program's graph (core ATen) and emits ONNX nodes."""

    def __init__(self, builder: _Builder, sentinel: Optional[int]):
        self.b = builder
        self.sentinel = sentinel

    # --- values -----------------------------------------------------------
    def concrete(self, s) -> int:
        """A size as an int; the symbolic batch becomes the sentinel."""
        if isinstance(s, int):
            return s
        if self.sentinel is None:
            raise ValueError(f"symbolic size {s} in a static export")
        return self.sentinel

    def shape(self, node) -> List[int]:
        return [self.concrete(s) for s in node.meta["val"].shape]

    def dtype(self, node) -> np.dtype:
        return _np_dtype(node.meta["val"].dtype)

    def name(self, v, like: Optional[np.dtype] = None) -> str:
        """The ONNX tensor name of a converted value: a graph tensor's name,
        a constant's initializer, or a Python scalar as a 0-d constant of
        ``like``'s dtype."""
        if isinstance(v, str):
            return v
        if isinstance(v, _Const):
            return self.b.const(_to_np(v.value), "c")
        if isinstance(v, (bool, int, float)):
            return self.b.const(np.asarray(v, like or np.float32), "lit")
        raise NotImplementedError(f"ONNX export: no tensor for {type(v).__name__} {v!r}")

    def const_array(self, v) -> Optional[np.ndarray]:
        if isinstance(v, _Const):
            return _to_np(v.value)
        if isinstance(v, (bool, int, float)):
            return np.asarray(v)
        if isinstance(v, str):
            return _const_chain(self.b, v)
        return None

    # --- the walk ----------------------------------------------------------
    def run(self, program, in_names: List[str]) -> List[str]:
        sig = program.graph_signature
        lifted = {}
        for spec in sig.input_specs:
            if spec.kind.name == "USER_INPUT":
                continue
            src = program.constants if spec.kind.name in ("CONSTANT_TENSOR", "CUSTOM_OBJ") \
                else program.state_dict
            if spec.target not in src and spec.target in program.constants:
                src = program.constants
            lifted[spec.arg.name] = src[spec.target]
        env: Dict[object, object] = {}
        users = iter(in_names)
        for node in program.graph.nodes:
            if node.op == "placeholder":
                if node.name in lifted:
                    env[node] = _Const(lifted[node.name].detach())
                else:
                    env[node] = next(users)
            elif node.op == "call_function":
                env[node] = self.call(node, env)
            elif node.op == "output":
                outs = node.args[0]
                return [self.name(env[o]) for o in outs]
        raise ValueError("the program has no output node")

    def call(self, node, env):
        def read(a):
            if isinstance(a, torch.fx.Node):
                return env[a]
            if isinstance(a, (list, tuple)):
                return type(a)(read(x) for x in a)
            return a

        args = [read(a) for a in node.args]
        kwargs = {k: read(v) for k, v in node.kwargs.items()}
        target = node.target
        if target is operator.getitem:
            return args[0][args[1]]
        if target in _PY_OPS:  # arithmetic on sizes
            return target(*[self.concrete(a) for a in args])
        name = str(target)
        if name == "aten.sym_size.int":
            return self.concrete(node.meta["val"])
        if name == "aten._assert_tensor_metadata.default":
            return None
        tensors = [a for a in _flat(args) + _flat(list(kwargs.values()))
                   if isinstance(a, (str, _Const))]
        if (all(isinstance(a, _Const) for a in tensors) and not _has_sym(node.meta.get("val"))
                and not (name in _NO_FOLD and node.meta["val"].numel() > FOLD_MAX_ELEMENTS)):
            return self.fold(target, args, kwargs)
        handler = _HANDLERS.get(name)
        if handler is None:
            shapes = [tuple(getattr(a.meta.get("val"), "shape", ())) for a in node.args
                      if isinstance(a, torch.fx.Node)]
            raise NotImplementedError(f"ONNX export: unsupported ATen op '{name}' (shapes {shapes})")
        return handler(self, node, *args, **kwargs)

    def fold(self, target, args, kwargs):
        def value(a):
            if isinstance(a, _Const):
                return a.value
            if isinstance(a, (list, tuple)):
                return type(a)(value(x) for x in a)
            return a

        with torch.no_grad():
            out = target(*[value(a) for a in args], **{k: value(v) for k, v in kwargs.items()})
        if isinstance(out, (list, tuple)):
            return [_Const(o) for o in out]
        return _Const(out)

    # --- helpers ------------------------------------------------------------
    def binop(self, node, onnx_op, x, y):
        dt = self.dtype(node)
        a, b = self.name(x, dt), self.name(y, dt)
        rank = len(node.meta["val"].shape)
        a = self._squeeze_const_ones(a, x, y, rank)
        b = self._squeeze_const_ones(b, y, x, rank)
        return self.b.emit(onnx_op, [a, b])[0]

    def _squeeze_const_ones(self, name, v, other, out_rank):
        """Drop leading 1-dims from a constant binop operand (as the JAX
        converter does, for NCHW-centric eltwise importers): only when the
        other operand is a graph tensor of the output's full rank."""
        if not isinstance(other, str) or isinstance(v, str):
            return name
        if len(self._rank_of(other)) != out_rank:
            return name
        arr = self.const_array(v)
        if arr is None or arr.ndim <= 1:
            return name
        sq = arr
        while sq.ndim > 1 and sq.shape[0] == 1:
            sq = sq[0]
        if sq.shape == arr.shape:
            return name
        return self.b.const(np.ascontiguousarray(sq), "c")

    def _rank_of(self, tensor_name: str):
        return self.b.shapes.get(tensor_name, ())

    def scalar(self, v) -> Optional[float]:
        arr = self.const_array(v)
        if arr is not None and arr.size == 1 and not isinstance(v, str):
            return arr.reshape(())
        return None

    def clip(self, node, x, lo=None, hi=None):
        """Clip with both bounds present (the absent side the dtype's
        extreme); consecutive clamps compose into one Clip when the inner
        one has no other consumer (the JAX converter's ``_clip``)."""
        dt = self.dtype(node)
        info = np.finfo(dt) if dt.kind == "f" else np.iinfo(dt)
        lo_v = float(lo) if lo is not None else float(info.min)
        hi_v = float(hi) if hi is not None else float(info.max)
        prev = self.b.produced_by.get(x)
        if (prev is not None and prev.op_type == "Clip" and len(prev.inputs) == 3
                and self.b.single_use.get(x, False)):
            plo = self.b.initializers.get(prev.inputs[1])
            phi = self.b.initializers.get(prev.inputs[2])
            if plo is not None and phi is not None:
                clo, chi = max(lo_v, float(plo.array)), min(hi_v, float(phi.array))
                if clo <= chi:
                    lo_v, hi_v, x = clo, chi, prev.inputs[0]
        return self.b.emit("Clip", [x, self.b.const(np.asarray(lo_v, dt), "clip"),
                                    self.b.const(np.asarray(hi_v, dt), "clip")])[0]

    def out(self, node, onnx_name: str) -> str:
        """Record a converted node's shape and consumer count on its output."""
        self.b.shapes[onnx_name] = tuple(self.shape(node))
        self.b.single_use[onnx_name] = len(node.users) == 1
        return onnx_name


_PY_OPS = {operator.mul, operator.add, operator.sub, operator.floordiv, operator.mod,
           operator.neg}


def _flat(xs):
    out = []
    for x in xs:
        if isinstance(x, (list, tuple)):
            out.extend(_flat(x))
        else:
            out.append(x)
    return out


def _const_chain(b: _Builder, name, depth: int = 6):
    """Resolve ``name`` to a numpy array if it is an initializer or a
    Transpose/Reshape/Identity chain over one (else None)."""
    if name in b.initializers:
        return b.initializers[name].array
    if depth == 0:
        return None
    node = b.produced_by.get(name)
    if node is None:
        return None
    if node.op_type == "Identity":
        return _const_chain(b, node.inputs[0], depth - 1)
    if node.op_type == "Transpose":
        arr = _const_chain(b, node.inputs[0], depth - 1)
        return None if arr is None else np.transpose(arr, node.attrs["perm"])
    if node.op_type == "Reshape":
        arr = _const_chain(b, node.inputs[0], depth - 1)
        shape = _const_chain(b, node.inputs[1], depth - 1)
        if arr is None or shape is None:
            return None
        return arr.reshape([int(s) for s in shape])
    return None


# a broadcast of a constant larger than this stays an Expand node rather
# than a batch-sized initializer (the JAX fold skips Expand for that reason)
_NO_FOLD = {"aten.expand.default"}
FOLD_MAX_ELEMENTS = 1 << 16

_HANDLERS = {}


def _handles(*names):
    def deco(fn):
        for n in names:
            _HANDLERS[n] = fn
        return fn
    return deco


def _unary(onnx_op):
    def fn(c, node, x, *rest):
        return c.out(node, c.b.emit(onnx_op, [c.name(x)])[0])
    return fn


for _aten, _onnx in (("relu", "Relu"), ("sigmoid", "Sigmoid"), ("exp", "Exp"), ("log", "Log"),
                     ("tanh", "Tanh"), ("sqrt", "Sqrt"), ("neg", "Neg"), ("abs", "Abs"),
                     ("sign", "Sign"), ("floor", "Floor"), ("ceil", "Ceil"),
                     ("round", "Round"), ("erf", "Erf"), ("logical_not", "Not")):
    _HANDLERS[f"aten.{_aten}.default"] = _unary(_onnx)


@_handles("aten.rsqrt.default")
def _rsqrt(c, node, x):
    return c.out(node, c.b.emit("Reciprocal", [c.b.emit("Sqrt", [c.name(x)])[0]])[0])


def _binary(onnx_op):
    def fn(c, node, x, y, alpha=1):
        if alpha != 1:
            raise NotImplementedError(f"ONNX export: {node.target} with alpha={alpha}")
        return c.out(node, c.binop(node, onnx_op, x, y))
    return fn


for _aten, _onnx in (("add", "Add"), ("sub", "Sub"), ("mul", "Mul"), ("pow", "Pow"),
                     ("remainder", "Mod")):
    _HANDLERS[f"aten.{_aten}.Tensor"] = _binary(_onnx)
    _HANDLERS[f"aten.{_aten}.Scalar"] = _binary(_onnx)
_HANDLERS["aten.pow.Tensor_Scalar"] = _binary("Pow")
_HANDLERS["aten.pow.Tensor_Tensor"] = _binary("Pow")


@_handles("aten.div.Tensor", "aten.div.Scalar")
def _div(c, node, x, y):
    return c.out(node, c.binop(node, "Div", x, y))


def _compare(onnx_op, negate=False):
    def fn(c, node, x, y):
        dt = _np_dtype(node.args[0].meta["val"].dtype) if isinstance(
            node.args[0], torch.fx.Node) else np.dtype(np.float32)
        out = c.b.emit(onnx_op, [c.name(x, dt), c.name(y, dt)])[0]
        if negate:
            out = c.b.emit("Not", [out])[0]
        return c.out(node, out)
    return fn


for _aten, _onnx in (("eq", "Equal"), ("lt", "Less"), ("le", "LessOrEqual"),
                     ("gt", "Greater"), ("ge", "GreaterOrEqual")):
    _HANDLERS[f"aten.{_aten}.Tensor"] = _compare(_onnx)
    _HANDLERS[f"aten.{_aten}.Scalar"] = _compare(_onnx)
_HANDLERS["aten.ne.Tensor"] = _HANDLERS["aten.ne.Scalar"] = _compare("Equal", negate=True)
for _aten, _onnx in (("logical_and", "And"), ("logical_or", "Or"),
                     ("bitwise_and", "And"), ("bitwise_or", "Or")):
    _HANDLERS[f"aten.{_aten}.default"] = _HANDLERS[f"aten.{_aten}.Tensor"] = _compare(_onnx)


@_handles("aten.maximum.default")
def _maximum(c, node, x, y):
    # max(x, 0) is Relu, max(x, c) a Clip (the JAX converter's peephole)
    for a, other in ((x, y), (y, x)):
        s = c.scalar(a)
        if s is not None and isinstance(other, str):
            if float(s) == 0:
                return c.out(node, c.b.emit("Relu", [other])[0])
            return c.out(node, c.clip(node, other, lo=s))
    return c.out(node, c.binop(node, "Max", x, y))


@_handles("aten.minimum.default")
def _minimum(c, node, x, y):
    for a, other in ((x, y), (y, x)):
        s = c.scalar(a)
        if s is not None and isinstance(other, str):
            return c.out(node, c.clip(node, other, hi=s))
    return c.out(node, c.binop(node, "Min", x, y))


@_handles("aten.clamp.default", "aten.clamp.Tensor")
def _clamp(c, node, x, lo=None, hi=None):
    lo = None if lo is None else c.scalar(lo)
    hi = None if hi is None else c.scalar(hi)
    return c.out(node, c.clip(node, c.name(x), lo=lo, hi=hi))


@_handles("aten.clamp_min.default", "aten.clamp_min.Tensor")
def _clamp_min(c, node, x, lo):
    return c.out(node, c.clip(node, c.name(x), lo=c.scalar(lo)))


@_handles("aten.clamp_max.default", "aten.clamp_max.Tensor")
def _clamp_max(c, node, x, hi):
    return c.out(node, c.clip(node, c.name(x), hi=c.scalar(hi)))


@_handles("aten.where.self")
def _where(c, node, cond, x, y):
    dt = c.dtype(node)
    return c.out(node, c.b.emit("Where", [c.name(cond), c.name(x, dt), c.name(y, dt)])[0])


@_handles("aten._to_copy.default")
def _to_copy(c, node, x, dtype=None, **kw):
    src = _np_dtype(node.args[0].meta["val"].dtype)
    dst = c.dtype(node)
    if src == dst:
        return x
    return c.out(node, c.b.emit("Cast", [c.name(x)], to=int(op.NP_TO_ONNX[dst]))[0])


@_handles("aten.clone.default", "aten.alias.default", "aten.detach.default",
          "aten.lift_fresh_copy.default", "aten.contiguous.default")
def _identity(c, node, x, *rest, **kw):
    return x


@_handles("aten.permute.default")
def _permute(c, node, x, dims):
    nd = len(node.meta["val"].shape)
    return c.out(node, c.b.transpose(c.name(x), [d % nd for d in dims]))


@_handles("aten.view.default", "aten.reshape.default", "aten._unsafe_view.default",
          "aten.unsqueeze.default", "aten.squeeze.dim", "aten.squeeze.dims",
          "aten.squeeze.default", "aten.flatten.using_ints")
def _reshape(c, node, x, *rest):
    return c.out(node, c.b.reshape(c.name(x), c.shape(node)))


@_handles("aten.expand.default")
def _expand(c, node, x, sizes, *rest):
    shape = c.shape(node)
    src = node.args[0].meta["val"] if isinstance(node.args[0], torch.fx.Node) else None
    xn = c.name(x, c.dtype(node))
    if src is not None and [c.concrete(s) for s in src.shape] == shape:
        return xn
    s = c.b.const(np.asarray(shape, np.int64), "shape")
    return c.out(node, c.b.emit("Expand", [xn, s])[0])


@_handles("aten.cat.default")
def _cat(c, node, tensors, dim=0):
    nd = len(node.meta["val"].shape)
    dt = c.dtype(node)
    return c.out(node, c.b.emit("Concat", [c.name(t, dt) for t in tensors], axis=dim % nd)[0])


@_handles("aten.split_with_sizes.default", "aten.split.Tensor")
def _split(c, node, x, sizes, dim=0):
    vals = node.meta["val"]
    nd = len(vals[0].shape)
    sizes = [c.concrete(v.shape[dim % nd]) for v in vals]
    s = c.b.const(np.asarray(sizes, np.int64), "split")
    outs = c.b.emit("Split", [c.name(x), s], n_out=len(sizes), axis=dim % nd)
    for o, v in zip(outs, vals):
        c.b.shapes[o] = tuple(c.concrete(d) for d in v.shape)
        c.b.single_use[o] = False
    return outs


@_handles("aten.slice.Tensor")
def _slice(c, node, x, dim=0, start=None, end=None, step=1):
    src = node.args[0].meta["val"]
    nd = len(src.shape)
    size = c.concrete(src.shape[dim % nd])
    start = 0 if start is None else c.concrete(start)
    end = size if end is None else min(c.concrete(end), size)
    if start == 0 and end >= size and step == 1:
        return x
    i64 = lambda v: c.b.const(np.asarray(v, np.int64))  # noqa: E731
    return c.out(node, c.b.emit("Slice", [c.name(x), i64([start]), i64([end]),
                                          i64([dim % nd]), i64([step])])[0])


@_handles("aten.flip.default")
def _flip(c, node, x, dims):
    nd = len(node.meta["val"].shape)
    dims = [d % nd for d in dims]
    i64 = lambda v: c.b.const(np.asarray(v, np.int64))  # noqa: E731
    return c.out(node, c.b.emit("Slice", [
        c.name(x), i64([-1] * len(dims)), i64([np.iinfo(np.int64).min] * len(dims)),
        i64(dims), i64([-1] * len(dims))])[0])


@_handles("aten.full_like.default", "aten.ones_like.default", "aten.zeros_like.default")
def _full_like(c, node, x, fill=None, **kw):
    if fill is None:
        fill = 1 if "ones" in str(node.target) else 0
    shape = c.shape(node)
    dt = c.dtype(node)
    one = c.b.const(np.full([1] * len(shape), fill, dt), "fill")
    s = c.b.const(np.asarray(shape, np.int64), "shape")
    return c.out(node, c.b.emit("Expand", [one, s])[0])


def _reduce(onnx_op):
    def fn(c, node, x, dims=None, keepdim=False, **kw):
        nd = len(node.args[0].meta["val"].shape)
        axes = list(range(nd)) if not dims else [d % nd for d in dims]
        if onnx_op == "ReduceSum":  # axes moved to an input at opset 13
            a = c.b.const(np.asarray(axes, np.int64), "axes")
            return c.out(node, c.b.emit(onnx_op, [c.name(x), a], keepdims=int(keepdim))[0])
        return c.out(node, c.b.emit(onnx_op, [c.name(x)], axes=axes, keepdims=int(keepdim))[0])
    return fn


_HANDLERS["aten.sum.dim_IntList"] = _reduce("ReduceSum")
_HANDLERS["aten.mean.dim"] = _reduce("ReduceMean")
_HANDLERS["aten.amax.default"] = _reduce("ReduceMax")
_HANDLERS["aten.amin.default"] = _reduce("ReduceMin")


@_handles("aten.argmax.default")
def _argmax(c, node, x, dim=None, keepdim=False):
    nd = len(node.args[0].meta["val"].shape)
    return c.out(node, c.b.emit("ArgMax", [c.name(x)], axis=dim % nd, keepdims=int(keepdim))[0])


@_handles("aten._softmax.default")
def _softmax(c, node, x, dim, half_to_float=False):
    nd = len(node.meta["val"].shape)
    return c.out(node, c.b.emit("Softmax", [c.name(x)], axis=dim % nd)[0])


@_handles("aten.convolution.default")
def _convolution(c, node, x, w, bias, stride, padding, dilation, transposed, output_padding,
                 groups):
    if transposed:
        return _conv_transpose_2x2(c, node, x, w, bias, stride, padding, output_padding, groups)
    w_shape = [int(s) for s in node.args[1].meta["val"].shape]
    inputs = [c.name(x), c.name(w)]
    if bias is not None:
        inputs.append(c.name(bias))
    pads = [int(p) for p in padding] * 2
    return c.out(node, c.b.emit(
        "Conv", inputs, kernel_shape=w_shape[2:], strides=[int(s) for s in stride], pads=pads,
        dilations=[int(d) for d in dilation], group=int(groups))[0])


def _conv_transpose_2x2(c, node, x, w, bias, stride, padding, output_padding, groups):
    """The ``Transpose`` block's 2x2 stride-2 transposed conv as the JAX
    package computes it (layers/common.py:Transpose there): a MatMul over the
    channels, then depth-to-space, then the bias."""
    w_arr = c.const_array(w)
    if (w_arr is None or list(w_arr.shape[2:]) != [2, 2] or list(stride) != [2, 2]
            or any(padding) or any(output_padding) or groups != 1):
        raise NotImplementedError("ONNX export: transposed convolution other than a constant "
                                  "2x2 stride-2 kernel without padding or groups")
    b, cin, h, wd = [c.concrete(s) for s in node.args[0].meta["val"].shape]
    cout = int(w_arr.shape[1])
    # y[b, o, 2i+p, 2j+q] = sum_c x[b, c, i, j] W[c, o, p, q] + bias[o]
    kmat = np.ascontiguousarray(np.transpose(w_arr, (0, 2, 3, 1)).reshape(cin, 4 * cout))
    y = c.b.transpose(c.name(x), [0, 2, 3, 1])                      # [b, h, w, c]
    y = c.b.emit("MatMul", [y, c.b.const(kmat, "w")])[0]            # [b, h, w, 4o]
    y = c.b.reshape(y, [b, h, wd, 2, 2, cout])
    y = c.b.transpose(y, [0, 1, 3, 2, 4, 5])                        # [b, h, p, w, q, o]
    y = c.b.reshape(y, [b, 2 * h, 2 * wd, cout])
    if bias is not None:
        y = c.b.emit("Add", [y, c.b.const(np.asarray(c.const_array(bias), np.float32), "bias")])[0]
    return c.out(node, c.b.transpose(y, [0, 3, 1, 2]))


@_handles("aten.max_pool2d_with_indices.default", "aten.max_pool2d.default")
def _max_pool(c, node, x, kernel, stride=(), padding=(0, 0), dilation=(1, 1), ceil_mode=False):
    if any(d != 1 for d in dilation) or ceil_mode:
        raise NotImplementedError("ONNX export: dilated or ceil-mode pooling")
    kernel = [int(k) for k in kernel]
    stride = [int(s) for s in stride] or kernel
    if len(padding) == 1:
        padding = list(padding) * 2
    out = c.b.emit("MaxPool", [c.name(x)], kernel_shape=kernel, strides=stride,
                   pads=[int(p) for p in padding] * 2)[0]
    vals = node.meta["val"]
    v = vals[0] if isinstance(vals, (list, tuple)) else vals
    c.b.shapes[out] = tuple(c.concrete(s) for s in v.shape)
    c.b.single_use[out] = False
    return [out, None] if isinstance(vals, (list, tuple)) else out


def _append_ort_nms(
    builder: _Builder,
    pred: str,
    batch: int,
    nc: int,
    max_obj: int,
    iou_thres: float,
    score_thres: float,
) -> List[str]:
    """Append the reference's ORT end2end tail to the graph: standard
    NonMaxSuppression + gather/sort ops turning ``pred`` [b, A, 5+nc]
    (xywh, obj, cls) into (num_det [b,1], det_boxes [b,S,4], det_scores
    [b,S], det_classes [b,S]) with S dynamic, score-sorted, zero/-1 padded
    — byte-for-byte the reference ONNX_ORT contract
    (reference: yolov6/models/end2end.py:140-189)."""
    b = builder
    i64 = lambda v: b.const(np.asarray(v, np.int64))  # noqa: E731
    nms_box, score = _split_pred(b, pred, nc, to_xyxy=True)  # [b,A,4] xyxy
    nms_score = b.transpose(score, (0, 2, 1))          # [b,nc,A]
    selected = b.emit(
        "NonMaxSuppression",
        [
            nms_box,
            nms_score,
            i64([max_obj]),
            b.const(np.asarray([iou_thres], np.float32)),
            b.const(np.asarray([score_thres], np.float32)),
        ],
        hint="nms",
    )[0]  # [S,3] int64 (batch, class, box)

    def sel_col(lo, hi):
        c = b.emit("Slice", [selected, i64([lo]), i64([hi]), i64([1])])[0]
        return c  # [S,1]

    batch_inds, cls_inds, box_inds = sel_col(0, 1), sel_col(1, 2), sel_col(2, 3)
    sel_score = b.emit("GatherND", [nms_score, selected])[0]        # [S]
    bb_idx = b.emit("Concat", [batch_inds, box_inds], axis=1)[0]    # [S,2]
    sel_box = b.emit("GatherND", [nms_box, bb_idx])[0]              # [S,4]
    sel_score2 = b.emit("Unsqueeze", [sel_score, i64([1])])[0]      # [S,1]
    dets = b.emit("Concat", [sel_box, sel_score2], axis=1)[0]       # [S,5]

    # batched_dets[bi] = dets where batch_inds == bi else 0
    dets_u = b.emit("Unsqueeze", [dets, i64([0])])[0]               # [1,S,5]
    s5 = b.emit("Shape", [dets])[0]                                  # [S,5]
    bshape = b.emit("Concat", [i64([batch]), s5], axis=0)[0]        # [b,S,5]
    batched = b.emit("Expand", [dets_u, bshape])[0]                 # [b,S,5]
    binds_t = b.transpose(batch_inds, (1, 0))                       # [1,S]
    btmpl = b.const(np.arange(batch, dtype=np.int64)[:, None], "batch_ids")
    in_batch = b.emit("Equal", [binds_t, btmpl])[0]                 # [b,S]
    in_batch3 = b.emit("Unsqueeze", [in_batch, i64([2])])[0]        # [b,S,1]
    zero = b.const(np.asarray(0.0, np.float32))
    batched = b.emit("Where", [in_batch3, batched, zero])[0]
    labels_t = b.transpose(cls_inds, (1, 0))                        # [1,S]
    sl = b.emit("Shape", [labels_t])[0]
    lshape = b.emit(
        "Concat", [i64([batch]), b.emit("Slice", [sl, i64([1]), i64([2])])[0]],
        axis=0,
    )[0]
    blabels = b.emit("Expand", [labels_t, lshape])[0]               # [b,S]
    neg1 = b.const(np.asarray(-1, np.int64))
    blabels = b.emit("Where", [in_batch, blabels, neg1])[0]

    # append one all-zero det / -1 label per image (keeps TopK non-empty
    # and terminates the valid prefix), then sort by score descending
    pad_d = b.const(np.zeros((batch, 1, 5), np.float32), "pad_det")
    pad_l = b.const(np.full((batch, 1), -1, np.int64), "pad_label")
    batched = b.emit("Concat", [batched, pad_d], axis=1)[0]         # [b,S+1,5]
    blabels = b.emit("Concat", [blabels, pad_l], axis=1)[0]         # [b,S+1]
    scores_col = b.emit(
        "Slice", [batched, i64([4]), i64([5]), i64([2])]
    )[0]                                                            # [b,S+1,1]
    scores2d = b.emit("Squeeze", [scores_col, i64([2])])[0]         # [b,S+1]
    k = b.emit(
        "Gather", [b.emit("Shape", [scores2d])[0], i64(1)], axis=0, hint="k"
    )[0]
    k1 = b.emit("Unsqueeze", [k, i64([0])])[0]
    _, topk_inds = b.emit("TopK", [scores2d, k1], n_out=2, axis=1,
                          largest=1, sorted=1)
    det_scores = b.emit("GatherElements", [scores2d, topk_inds], axis=1)[0]
    det_classes = b.emit("GatherElements", [blabels, topk_inds], axis=1)[0]
    ti3 = b.emit("Unsqueeze", [topk_inds, i64([2])])[0]             # [b,S+1,1]
    s3 = b.emit("Shape", [batched])[0]
    ti3e = b.emit(
        "Expand",
        [ti3, b.emit("Concat",
                     [b.emit("Slice", [s3, i64([0]), i64([2])])[0], i64([5])],
                     axis=0)[0]],
    )[0]
    sorted_dets = b.emit("GatherElements", [batched, ti3e], axis=1)[0]
    det_boxes = b.emit("Slice", [sorted_dets, i64([0]), i64([4]), i64([2])])[0]
    pos = b.emit("Greater", [det_scores, zero])[0]
    pos_i = b.emit("Cast", [pos], to=int(op.NP_TO_ONNX[np.dtype(np.int64)]))[0]
    num_det = b.emit("ReduceSum", [pos_i, i64([1])], keepdims=1)[0]  # [b,1]
    return [num_det, det_boxes, det_scores, det_classes]


def _split_pred(builder: _Builder, pred: str, nc: int, to_xyxy: bool):
    """Common head of every end2end tail: split [b,A,5+nc] into boxes and
    per-class scores (cls*obj); optionally xywh->xyxy via the reference's
    4x4 convert matrix (reference: yolov6/models/end2end.py:149-160)."""
    b = builder
    i64 = lambda v: b.const(np.asarray(v, np.int64))  # noqa: E731

    def col_slice(x, lo, hi, axis=2):
        return b.emit("Slice", [x, i64([lo]), i64([hi]), i64([axis])])[0]

    box = col_slice(pred, 0, 4)          # [b,A,4] xywh
    conf = col_slice(pred, 4, 5)         # [b,A,1]
    cls = col_slice(pred, 5, 5 + nc)     # [b,A,nc]
    score = b.emit("Mul", [cls, conf])[0]
    if to_xyxy:
        cm = b.const(
            np.array(
                [[1, 0, 1, 0], [0, 1, 0, 1], [-0.5, 0, 0.5, 0], [0, -0.5, 0, 0.5]],
                np.float32,
            ),
            "convert_matrix",
        )
        box = b.emit("MatMul", [box, cm])[0]           # [b,A,4] xyxy
    return box, score


def _append_trt8_nms(
    builder: _Builder,
    pred: str,
    nc: int,
    max_obj: int,
    iou_thres: float,
    score_thres: float,
) -> List[str]:
    """Append the TensorRT>=8 ``EfficientNMS_TRT`` plugin node (domain TRT).

    Matches the reference's exported op + attribute layout byte-for-byte:
    boxes stay xywh (box_coding=1), scores are [b,A,nc], outputs are
    (num_dets [b,1] i32, det_boxes [b,max_obj,4] f32, det_scores
    [b,max_obj] f32, det_classes [b,max_obj] i32)
    (reference: yolov6/models/end2end.py:30-76,237-257)."""
    b = builder
    box, score = _split_pred(b, pred, nc, to_xyxy=False)
    return b.emit(
        "EfficientNMS_TRT",
        [box, score],
        n_out=4,
        hint="trt8_nms",
        domain="TRT",
        background_class=-1,
        box_coding=1,
        iou_threshold=float(iou_thres),
        max_output_boxes=int(max_obj),
        plugin_version="1",
        score_activation=0,
        score_threshold=float(score_thres),
    )


def _append_trt7_nms(
    builder: _Builder,
    pred: str,
    nc: int,
    max_obj: int,
    iou_thres: float,
    score_thres: float,
) -> List[str]:
    """Append the TensorRT 7 ``BatchedNMSDynamic_TRT`` plugin node.

    Boxes go through xywh->xyxy then gain a shared-location class axis
    ([b,A,1,4]); outputs are (num_dets i32, det_boxes f32, det_scores f32,
    det_classes f32 -> Cast i32), keepTopK = max_obj
    (reference: yolov6/models/end2end.py:78-137,192-233)."""
    b = builder
    i64 = lambda v: b.const(np.asarray(v, np.int64))  # noqa: E731
    box, score = _split_pred(b, pred, nc, to_xyxy=True)
    box4 = b.emit("Unsqueeze", [box, i64([2])])[0]     # [b,A,1,4] shareLocation
    num_det, det_boxes, det_scores, det_classes_f = b.emit(
        "BatchedNMSDynamic_TRT",
        [box4, score],
        n_out=4,
        hint="trt7_nms",
        domain="TRT",
        shareLocation=1,
        plugin_version="1",
        backgroundLabelId=-1,
        numClasses=int(nc),
        topK=1000,
        keepTopK=int(max_obj),
        scoreThreshold=float(score_thres),
        iouThreshold=float(iou_thres),
        isNormalized=0,
        clipBoxes=0,
        scoreBits=16,
        caffeSemantics=1,
    )
    det_classes = b.emit(
        "Cast", [det_classes_f], to=int(op.NP_TO_ONNX[np.dtype(np.int32)])
    )[0]
    return [num_det, det_boxes, det_scores, det_classes]


def make_dynamic_batch(m, sentinel: int, dim_param: str = "batch") -> None:
    """Rewrite a model traced at a sentinel batch size into a dynamic-batch
    model (reference: deploy/ONNX/export_onnx.py --dynamic-batch).

    The converter bakes shapes into Reshape/Expand initializers; tracing at
    a large prime sentinel makes the batch dimension uniquely identifiable
    in them. Each Reshape shape gets its sentinel element replaced by -1
    (inferred); each Expand target is rebuilt at runtime from
    ``Shape(input)[0:1]``. Graph IO batch dims become ``dim_param``.
    Mutates the ParsedModel in place.
    """
    from yolov6_tpu_torch.export.onnx_proto import ParsedNode

    inits = m.initializers
    consumers: Dict[str, list] = {}
    for node in m.nodes:
        for i in node.inputs:
            consumers.setdefault(i, []).append(node)

    helpers: List[ParsedNode] = []
    bdim = None

    def get_bdim() -> str:
        nonlocal bdim
        if bdim is None:
            inp = m.inputs[0][0]
            inits["dynb_zero"] = np.asarray([0], np.int64)
            inits["dynb_one"] = np.asarray([1], np.int64)
            helpers.append(ParsedNode("Shape", [inp], ["dynb_shape"], "dynb_shape", {}))
            helpers.append(
                ParsedNode("Slice", ["dynb_shape", "dynb_zero", "dynb_one"],
                           ["dynb_batch"], "dynb_batch", {})
            )
            bdim = "dynb_batch"
        return bdim

    for name, arr in list(inits.items()):
        if arr.dtype != np.int64 or arr.ndim != 1 or not (arr == sentinel).any():
            continue
        if int((arr == sentinel).sum()) != 1:
            raise ValueError(
                f"dynamic batch: sentinel appears {int((arr == sentinel).sum())} "
                f"times in shape initializer {name} ({arr.tolist()})"
            )
        for node in consumers.get(name, []):
            if node.op_type == "Reshape":
                rname = name + "_dynr"
                if rname not in inits:
                    new = arr.copy()
                    new[arr == sentinel] = -1
                    inits[rname] = new
                node.inputs = [rname if i == name else i for i in node.inputs]
            elif node.op_type == "Expand":
                idx = int(np.argmax(arr == sentinel))
                if idx != 0:
                    raise ValueError(
                        f"dynamic batch: Expand target {arr.tolist()} has the "
                        f"batch at position {idx}"
                    )
                dname = name + "_dyne"
                if dname not in inits and not any(
                    h.outputs[0] == dname for h in helpers
                ):
                    inits[name + "_rest"] = arr[1:].copy()
                    helpers.append(
                        ParsedNode("Concat", [get_bdim(), name + "_rest"],
                                   [dname], dname, {"axis": 0})
                    )
                node.inputs = [dname if i == name else i for i in node.inputs]
            else:
                raise ValueError(
                    f"dynamic batch: sentinel initializer {name} consumed by "
                    f"unsupported op {node.op_type}"
                )
        inits.pop(name, None)
    m.nodes = helpers + m.nodes
    m.inputs = [(n, et, (dim_param,) + tuple(sh[1:])) for n, et, sh in m.inputs]
    m.outputs = [(n, et, (dim_param,) + tuple(sh[1:])) for n, et, sh in m.outputs]


def _prune_dead(builder: _Builder, out_names: List[str]):
    """Drop nodes/initializers not reachable from the graph outputs."""
    live = set(out_names)
    for node in reversed(builder.nodes):
        if any(o in live for o in node.outputs):
            live.update(node.inputs)
    builder.nodes = [n for n in builder.nodes if any(o in live for o in n.outputs)]
    builder.initializers = {
        k: v for k, v in builder.initializers.items() if k in live
    }
    return live


def export_onnx(
    fn,
    example_args: Sequence,
    path: Optional[str] = None,
    *,
    opset: int = 13,
    graph_name: str = "yolov6",
    input_names: Optional[List[str]] = None,
    output_names: Optional[List[str]] = None,
    nms: Optional[dict] = None,
    doc: str = "",
    dynamic_batch: bool = False,
) -> bytes:
    """Trace ``fn(*example_args)`` with ``torch.export`` and serialize it as
    an ONNX model (the JAX ``export_onnx``'s signature; ``fn`` is a module
    or a function of tensors, ``example_args`` tensors or numpy arrays).

    Shapes are static, taken from the example args, unless
    ``dynamic_batch``: then dim 0 of every input is traced as a symbol and
    written as ``SENTINEL``, for ``make_dynamic_batch`` to rewrite. Returns
    the serialized ModelProto bytes; also written to ``path`` if given.

    ``nms`` (keys: max_obj, iou_thres, score_thres, trt_version) appends an
    end2end tail: ``fn`` must then return a single [b, A, 5+nc] prediction
    tensor, and the model outputs become (num_det, det_boxes, det_scores,
    det_classes). trt_version None/0 emits the standard NonMaxSuppression
    op (ORT contract, dynamic det dim — reference:
    yolov6/models/end2end.py:140-189); 8 emits the EfficientNMS_TRT plugin
    node, 7 BatchedNMSDynamic_TRT (fixed max_obj det dim — reference:
    yolov6/models/end2end.py:30-137).
    """
    module = fn if isinstance(fn, torch.nn.Module) else _FnModule(fn)
    args = tuple(torch.as_tensor(a) for a in example_args)
    dynamic_shapes = None
    if dynamic_batch:
        if any(a.shape[0] < 2 for a in args):
            raise ValueError("a dynamic batch is traced from an example batch of at least 2")
        batch = torch.export.Dim("batch", min=1, max=SENTINEL - 1)
        dynamic_shapes = tuple({0: batch} for _ in args)
    with torch.no_grad():
        program = torch.export.export(module, args, dynamic_shapes=dynamic_shapes)
    program = program.run_decompositions()

    builder = _Builder()
    in_names = input_names or [f"input_{i}" for i in range(len(args))]
    if len(in_names) != len(args):
        raise ValueError("input_names length mismatch")
    conv = _Converter(builder, SENTINEL if dynamic_batch else None)
    raw_outs = conv.run(program, list(in_names))
    out_vals = [n.meta["val"] for n in next(
        n for n in program.graph.nodes if n.op == "output").args[0]]

    def spec(v):
        return (int(op.NP_TO_ONNX[_np_dtype(v.dtype)]), tuple(conv.concrete(s) for s in v.shape))

    out_specs: List[tuple] = [spec(v) for v in out_vals]
    extra_opsets: Dict[str, int] = {}
    if nms is not None:
        if len(raw_outs) != 1:
            raise ValueError("nms tail needs a single [b, A, 5+nc] output")
        batch, nc = out_specs[0][1][0], out_specs[0][1][-1] - 5
        max_obj = int(nms.get("max_obj", 100))
        iou_thres = float(nms.get("iou_thres", 0.45))
        score_thres = float(nms.get("score_thres", 0.25))
        trt_version = nms.get("trt_version")
        i64 = int(op.NP_TO_ONNX[np.dtype(np.int64)])
        i32 = int(op.NP_TO_ONNX[np.dtype(np.int32)])
        f32 = int(op.NP_TO_ONNX[np.dtype(np.float32)])
        if trt_version:  # TensorRT plugin contracts: fixed max_obj det dim
            append = _append_trt8_nms if int(trt_version) >= 8 else _append_trt7_nms
            raw_outs = append(builder, raw_outs[0], nc, max_obj, iou_thres, score_thres)
            extra_opsets["TRT"] = 1
            out_specs = [
                (i32, (batch, 1)),
                (f32, (batch, max_obj, 4)),
                (f32, (batch, max_obj)),
                (i32, (batch, max_obj)),
            ]
        else:  # ORT NonMaxSuppression contract: dynamic det dim
            raw_outs = _append_ort_nms(
                builder, raw_outs[0], batch, nc, max_obj, iou_thres, score_thres
            )
            out_specs = [
                (i64, (batch, 1)),
                (f32, (batch, "dets", 4)),
                (f32, (batch, "dets")),
                (i64, (batch, "dets")),
            ]
        output_names = output_names or [
            "num_dets", "det_boxes", "det_scores", "det_classes"
        ]

    out_names = output_names or [f"output_{i}" for i in range(len(raw_outs))]
    if len(out_names) != len(raw_outs):
        raise ValueError("output_names length mismatch")
    final = []
    for raw, name in zip(raw_outs, out_names):
        # bind each graph output through an Identity so renaming can never
        # break other consumers of the producing node's tensor
        node = op.Node("Identity", [raw], [name], name=f"out_{name}")
        builder.nodes.append(node)
        builder.produced_by[name] = node
        final.append(name)

    _prune_dead(builder, final)

    graph = op.Graph(
        name=graph_name,
        nodes=builder.nodes,
        inputs=[op.ValueInfo(n, int(op.NP_TO_ONNX[_np_dtype(a.dtype)]),
                             (SENTINEL if dynamic_batch else a.shape[0],) + tuple(a.shape[1:]))
                for n, a in zip(in_names, args)],
        outputs=[op.ValueInfo(n, et, shape) for n, (et, shape) in zip(final, out_specs)],
        initializers=list(builder.initializers.values()),
    )
    data = op.encode_model(graph, opset=opset, doc=doc, extra_opsets=extra_opsets)
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


class _FnModule(torch.nn.Module):
    """A function of tensors as a module, for ``torch.export``. Modules it
    closes over are registered, so their weights are lifted."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)
