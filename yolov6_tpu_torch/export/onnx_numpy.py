"""Pure-numpy ONNX reference interpreter (opset 13 subset): a copy of
yolov6_tpu/export/onnx_numpy.py.

onnxruntime is not installed in this environment, so exported models are
execution-tested against this interpreter: it parses the serialized
ModelProto (export/onnx_proto.py) and evaluates the graph with numpy,
implementing each op per the ONNX operator spec — independently of the
ATen->ONNX mapping in onnx_export.py, so a wrong attribute translation
(pads order, perms, group counts...) shows up as a numeric mismatch against
the source torch function in tests/test_torch_onnx_export.py.

Covers exactly the op set the exporter emits; unknown ops raise by name.
Conv/MaxPool use stride-tricks windows (no copies) — fast enough for
test-sized images; this is a correctness oracle, not a serving runtime
(serving is the .pt2 artifact, models/end2end.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from yolov6_tpu_torch.export.onnx_proto import ONNX_TO_NP, ParsedModel, parse_model

_INT64_MIN = np.iinfo(np.int64).min
_INT64_MAX = np.iinfo(np.int64).max


def _conv2d(x, w, strides, pads, dilations, group):
    """x [N,C,H,W], w [O,C/g,kh,kw] -> [N,O,H',W'] (ONNX Conv, no bias)."""
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    if dilations != [1, 1]:
        # dilate the kernel with zeros (correct, rarely exercised)
        dk = np.zeros(
            (o, cg, (kh - 1) * dilations[0] + 1, (kw - 1) * dilations[1] + 1),
            w.dtype,
        )
        dk[:, :, :: dilations[0], :: dilations[1]] = w
        w, (kh, kw) = dk, dk.shape[2:]
    xp = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])))
    win = np.lib.stride_tricks.sliding_window_view(xp, (kh, kw), axis=(2, 3))
    win = win[:, :, :: strides[0], :: strides[1]]  # [N,C,H',W',kh,kw]
    outs = []
    cs, os_ = c // group, o // group
    for g in range(group):
        outs.append(
            np.einsum(
                "nchwkl,ockl->nohw",
                win[:, g * cs : (g + 1) * cs],
                w[g * os_ : (g + 1) * os_],
                optimize=True,
            )
        )
    return np.concatenate(outs, axis=1) if group > 1 else outs[0]


def _maxpool2d(x, kernel, strides, pads):
    xp = np.pad(
        x,
        ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])),
        constant_values=-np.inf,
    )
    win = np.lib.stride_tricks.sliding_window_view(
        xp, tuple(kernel), axis=(2, 3)
    )
    return win[:, :, :: strides[0], :: strides[1]].max(axis=(-2, -1)).astype(x.dtype)


def _slice(data, starts, ends, axes=None, steps=None):
    nd = data.ndim
    axes = list(range(len(starts))) if axes is None else [int(a) % nd for a in axes]
    steps = [1] * len(starts) if steps is None else [int(s) for s in steps]
    sl = [slice(None)] * nd
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        st, en, sp = int(st), int(en), int(sp)
        dim = data.shape[ax]
        if sp > 0:
            st = min(st + dim if st < 0 else st, dim)
            en = min(en + dim if en < 0 else en, dim) if en < _INT64_MAX else dim
            sl[ax] = slice(st, en, sp)
        else:
            st = st + dim if st < 0 else min(st, dim - 1)
            en = None if en <= _INT64_MIN + dim else (en + dim if en < 0 else en)
            sl[ax] = slice(st, en, sp)
    return data[tuple(sl)]


def _reduce(fn, x, axes, keepdims):
    ax = None if axes is None or len(np.atleast_1d(axes)) == 0 else tuple(
        int(a) for a in np.atleast_1d(axes)
    )
    return fn(x, axis=ax, keepdims=bool(keepdims))


_erf = np.vectorize(math.erf, otypes=[np.float32])


class OnnxRunner:
    """Parse once, call many times: runner = OnnxRunner(model_bytes);
    outputs = runner(input0, input1, ...)."""

    def __init__(self, model: bytes | ParsedModel):
        self.model = parse_model(model) if isinstance(model, (bytes, bytearray)) else model
        self.input_names = [n for n, _, _ in self.model.inputs]
        self.output_names = [n for n, _, _ in self.model.outputs]
        # optional per-tensor observation hook: observer(name, value, node)
        # after every node (used by ONNX-level PTQ calibration, quant/onnx_ptq)
        self.observer = None

    def __call__(self, *args: np.ndarray) -> List[np.ndarray]:
        if len(args) != len(self.input_names):
            raise ValueError(
                f"expected {len(self.input_names)} inputs, got {len(args)}"
            )
        env: Dict[str, np.ndarray] = dict(self.model.initializers)
        for name, arr in zip(self.input_names, args):
            env[name] = np.asarray(arr)
        for node in self.model.nodes:
            fn = getattr(self, f"op_{node.op_type}", None)
            if fn is None:
                raise NotImplementedError(f"ONNX op '{node.op_type}'")
            ins = [env[i] if i else None for i in node.inputs]
            outs = fn(node.attrs, *ins)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for name, val in zip(node.outputs, outs):
                env[name] = val
            if self.observer is not None:
                for name in node.outputs:
                    self.observer(name, env[name], node)
        return [env[n] for n in self.output_names]

    # --- elementwise ---
    def op_Add(self, a, x, y):
        return x + y

    def op_Sub(self, a, x, y):
        return x - y

    def op_Mul(self, a, x, y):
        return x * y

    def op_Div(self, a, x, y):
        if np.asarray(x).dtype.kind == "f":
            return x / y
        # ONNX integer Div truncates toward zero (C semantics), not floor
        return np.trunc(np.asarray(x, np.float64) / y).astype(np.asarray(x).dtype)

    def op_Max(self, a, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = np.maximum(out, x)
        return out

    def op_Min(self, a, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = np.minimum(out, x)
        return out

    def op_Pow(self, a, x, y):
        return np.power(x, y).astype(x.dtype)

    def op_Mod(self, a, x, y):
        return (np.fmod(x, y) if a.get("fmod", 0) else np.mod(x, y)).astype(x.dtype)

    def op_Relu(self, a, x):
        return np.maximum(x, 0)

    def op_Sigmoid(self, a, x):
        return (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(x.dtype)

    def op_Exp(self, a, x):
        return np.exp(x)

    def op_Log(self, a, x):
        return np.log(x)

    def op_Tanh(self, a, x):
        return np.tanh(x)

    def op_Sqrt(self, a, x):
        return np.sqrt(x)

    def op_Reciprocal(self, a, x):
        return (1.0 / x).astype(x.dtype)

    def op_Neg(self, a, x):
        return -x

    def op_Abs(self, a, x):
        return np.abs(x)

    def op_Sign(self, a, x):
        return np.sign(x)

    def op_Floor(self, a, x):
        return np.floor(x)

    def op_Ceil(self, a, x):
        return np.ceil(x)

    def op_Round(self, a, x):
        return np.round(x)  # half-to-even, matching ONNX Round

    def op_Erf(self, a, x):
        return _erf(x).astype(x.dtype)

    def op_Clip(self, a, x, lo=None, hi=None):
        if lo is not None:
            x = np.maximum(x, lo)
        if hi is not None:
            x = np.minimum(x, hi)
        return x

    def op_Cast(self, a, x):
        return x.astype(ONNX_TO_NP[a["to"]])

    def op_Identity(self, a, x):
        return x

    # --- comparison / logic ---
    def op_Equal(self, a, x, y):
        return x == y

    def op_Less(self, a, x, y):
        return x < y

    def op_LessOrEqual(self, a, x, y):
        return x <= y

    def op_Greater(self, a, x, y):
        return x > y

    def op_GreaterOrEqual(self, a, x, y):
        return x >= y

    def op_Not(self, a, x):
        return ~x

    def op_And(self, a, x, y):
        return x & y

    def op_Or(self, a, x, y):
        return x | y

    def op_Where(self, a, c, x, y):
        return np.where(c, x, y)

    # --- shape ---
    def op_Reshape(self, a, x, shape):
        return x.reshape([int(s) for s in shape])

    def op_Transpose(self, a, x):
        return np.transpose(x, a["perm"])

    def op_Concat(self, a, *xs):
        return np.concatenate(xs, axis=a["axis"])

    def op_Expand(self, a, x, shape):
        target = np.broadcast_shapes(x.shape, tuple(int(s) for s in shape))
        return np.broadcast_to(x, target)

    def op_Split(self, a, x, split=None):
        axis = a.get("axis", 0)
        if split is None:
            n = a["num_outputs"]
            sizes = [x.shape[axis] // n] * n
        else:
            sizes = [int(s) for s in split]
        idx = np.cumsum(sizes)[:-1]
        return tuple(np.split(x, idx, axis=axis))

    def op_Slice(self, a, x, starts, ends, axes=None, steps=None):
        return _slice(x, starts, ends, axes, steps)

    def op_Pad(self, a, x, pads, value=None):
        nd = x.ndim
        pads = [int(p) for p in pads]
        width = [(pads[i], pads[i + nd]) for i in range(nd)]
        cv = 0 if value is None else np.asarray(value).item()
        return np.pad(x, width, constant_values=cv)

    # --- reductions ---
    def op_ReduceMax(self, a, x):
        return _reduce(np.max, x, a.get("axes"), a.get("keepdims", 1))

    def op_ReduceMin(self, a, x):
        return _reduce(np.min, x, a.get("axes"), a.get("keepdims", 1))

    def op_ReduceSum(self, a, x, axes=None):
        ax = axes if axes is not None else a.get("axes")
        return _reduce(np.sum, x, ax, a.get("keepdims", 1)).astype(x.dtype)

    def op_ReduceMean(self, a, x, axes=None):
        ax = axes if axes is not None else a.get("axes")
        return _reduce(np.mean, x, ax, a.get("keepdims", 1)).astype(x.dtype)

    def op_ArgMax(self, a, x):
        out = np.argmax(x, axis=a.get("axis", 0))
        if a.get("keepdims", 1):
            out = np.expand_dims(out, a.get("axis", 0))
        return out.astype(np.int64)

    def op_Softmax(self, a, x):
        ax = a.get("axis", -1)
        e = np.exp(x - x.max(axis=ax, keepdims=True))
        return (e / e.sum(axis=ax, keepdims=True)).astype(x.dtype)

    # --- quantization ---
    @staticmethod
    def _axis_shape(scale, x, axis):
        if np.ndim(scale) == 0:
            return scale
        shape = [1] * x.ndim
        shape[axis] = -1
        return np.asarray(scale).reshape(shape)

    def op_QuantizeLinear(self, a, x, scale, zp=None):
        s = self._axis_shape(scale, x, a.get("axis", 1))
        dt = np.int8 if zp is None else np.asarray(zp).dtype
        info = np.iinfo(dt)
        z = 0 if zp is None else self._axis_shape(zp, x, a.get("axis", 1))
        q = np.round(x / s) + z  # round half-to-even per spec
        return np.clip(q, info.min, info.max).astype(dt)

    def op_DequantizeLinear(self, a, x, scale, zp=None):
        axis = a.get("axis", 1)
        s = self._axis_shape(scale, x, axis)
        z = 0 if zp is None else self._axis_shape(zp, x, axis)
        return ((x.astype(np.float32) - z) * s).astype(np.float32)

    # --- gather / sort / NMS (the ORT end2end tail) ---
    def op_Shape(self, a, x):
        return np.asarray(x.shape, np.int64)

    def op_Unsqueeze(self, a, x, axes=None):
        axes = a.get("axes") if axes is None else axes
        out = np.asarray(x)
        for ax in sorted(int(v) for v in np.atleast_1d(axes)):
            out = np.expand_dims(out, ax)
        return out

    def op_Squeeze(self, a, x, axes=None):
        axes = a.get("axes") if axes is None else axes
        if axes is None:
            return np.squeeze(x)
        return np.squeeze(x, tuple(int(v) for v in np.atleast_1d(axes)))

    def op_Gather(self, a, data, indices):
        return np.take(data, np.asarray(indices), axis=a.get("axis", 0))

    def op_GatherND(self, a, data, indices):
        if a.get("batch_dims", 0):
            raise NotImplementedError("GatherND batch_dims")
        indices = np.asarray(indices)
        idx = tuple(indices[..., i] for i in range(indices.shape[-1]))
        return data[idx]

    def op_GatherElements(self, a, data, indices):
        return np.take_along_axis(data, np.asarray(indices), axis=a.get("axis", 0))

    def op_TopK(self, a, x, k):
        axis = a.get("axis", -1)
        k = int(np.asarray(k).reshape(-1)[0])
        idx = np.argsort(-x if a.get("largest", 1) else x, axis=axis, kind="stable")
        idx = np.take(idx, range(k), axis=axis)
        return np.take_along_axis(x, idx, axis=axis), idx.astype(np.int64)

    def op_NonMaxSuppression(self, a, boxes, scores, max_out=None,
                             iou_th=None, score_th=None):
        """Per ONNX spec: boxes [b,A,4], scores [b,C,A] ->
        selected_indices [S,3] (batch, class, box). Corner order-agnostic."""
        max_out = 0 if max_out is None else int(np.asarray(max_out).reshape(-1)[0])
        iou_th = 0.0 if iou_th is None else float(np.asarray(iou_th).reshape(-1)[0])
        score_th = (
            None if score_th is None
            else float(np.asarray(score_th).reshape(-1)[0])
        )
        if a.get("center_point_box", 0):
            cx, cy, w, h = (boxes[..., i] for i in range(4))
            boxes = np.stack(
                [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1
            )
        lo = np.minimum(boxes[..., :2], boxes[..., 2:])
        hi = np.maximum(boxes[..., :2], boxes[..., 2:])
        area = np.prod(hi - lo, axis=-1)
        sel = []
        for bi in range(scores.shape[0]):
            for ci in range(scores.shape[1]):
                sc = scores[bi, ci]
                order = np.argsort(-sc, kind="stable")
                if score_th is not None:
                    order = order[sc[order] > score_th]
                keep: list = []
                for i in order:
                    if max_out and len(keep) >= max_out:
                        break
                    if keep:
                        kl, kh = lo[bi, keep], hi[bi, keep]
                        iw = np.minimum(hi[bi, i], kh) - np.maximum(lo[bi, i], kl)
                        inter = np.prod(np.clip(iw, 0, None), axis=-1)
                        iou = inter / (area[bi, i] + area[bi, keep] - inter + 1e-12)
                        if (iou > iou_th).any():
                            continue
                    keep.append(int(i))
                sel.extend([bi, ci, i] for i in keep)
        return np.asarray(sel, np.int64).reshape(-1, 3)

    # --- linear / conv / pool ---
    def op_MatMul(self, a, x, y):
        return np.matmul(x, y)

    def op_Gemm(self, a, x, y, c=None):
        out = np.matmul(
            x.T if a.get("transA") else x, y.T if a.get("transB") else y
        )
        out = out * a.get("alpha", 1.0)
        if c is not None:
            out = out + c * a.get("beta", 1.0)
        return out.astype(x.dtype)

    def op_Conv(self, a, x, w, b=None):
        kh, kw = w.shape[2], w.shape[3]
        strides = list(a.get("strides", [1, 1]))
        pads = list(a.get("pads", [0, 0, 0, 0]))
        dil = list(a.get("dilations", [1, 1]))
        out = _conv2d(x, w, strides, pads, dil, a.get("group", 1))
        if b is not None:
            out = out + b.reshape(1, -1, 1, 1)
        return out.astype(x.dtype)

    def op_MaxPool(self, a, x):
        return _maxpool2d(
            x,
            list(a["kernel_shape"]),
            list(a.get("strides", [1] * len(a["kernel_shape"]))),
            list(a.get("pads", [0, 0, 0, 0])),
        )


def run_model(model_bytes: bytes, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
    return OnnxRunner(model_bytes)(*inputs)
