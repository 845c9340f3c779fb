"""TorchScript export, and the ONNX graph run as torch ops (port of
yolov6_tpu/export/torch_export.py).

The reference ships a TorchScript artifact as the NCNN/PNNX entry point
(reference: deploy/NCNN/export_torchscript.py: the deploy-mode model traced
with ``torch.jit.trace`` into ``.torchscript.pt``). The port's model is
torch, so ``export_torchscript`` takes the reference's own route and traces
the deploy model plus decode; the JAX package, whose model is JAX, takes a
detour through its ONNX file. The contract is the JAX artifact's: NHWC fp32
images in, ``[b, A, 5+nc]`` decoded predictions out, no NMS.

``OnnxTorchModule`` (copied) executes any ONNX graph the port writes with
torch ops, on the device of its inputs: it is how the port's ONNX files run
on the card. Beyond the copy, it runs ``NonMaxSuppression`` (the end2end ORT
tail) through the port's keep, so an end2end file launches the NMS kernel. Nodes whose inputs are all compile-time constants fold with the
numpy interpreter (export/onnx_numpy.py), so Reshape targets, Slice bounds
and Split sizes stay static; every node touching a tensor maps to the
equivalent torch op. Unknown ops raise by name.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolov6_tpu_torch.export.onnx_numpy import OnnxRunner
from yolov6_tpu_torch.export.onnx_proto import ONNX_TO_NP, ParsedModel, parse_model


class _Placement:
    """Where ``_t`` puts a numpy constant while an ``OnnxTorchModule`` runs:
    the device of its inputs; the module's initializers are copied there
    once (``cache``, by the array's id)."""

    device = None
    cache: Dict[int, "torch.Tensor"] = {}


def _t(v):
    """Promote a numpy constant to a torch tensor (a trace constant) on the
    running module's device."""
    if torch.is_tensor(v):
        return v
    a = np.asarray(v)
    dev = _Placement.device
    if dev is None or dev.type == "cpu":
        return torch.from_numpy(np.ascontiguousarray(a))
    hit = _Placement.cache.get(id(v))
    if hit is not None:
        return hit
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _const(v, what: str) -> np.ndarray:
    """Require a compile-time constant (shape/index operand)."""
    if torch.is_tensor(v):
        raise NotImplementedError(
            f"data-dependent {what} cannot be torch.jit.trace'd statically"
        )
    return np.asarray(v)


def _axes(a, attrs_axes, runtime_axes):
    ax = attrs_axes if runtime_axes is None else _const(runtime_axes, "axes")
    if ax is None:
        return None
    ax = tuple(int(v) for v in np.atleast_1d(ax))
    return ax if ax else None


class _TorchOps:
    """ONNX op -> torch mapping. Each method takes (attrs, *inputs) where
    inputs are torch tensors or numpy constants (mixed)."""

    # --- elementwise / binary ---
    @staticmethod
    def op_Add(a, x, y):
        return _t(x) + _t(y)

    @staticmethod
    def op_Sub(a, x, y):
        return _t(x) - _t(y)

    @staticmethod
    def op_Mul(a, x, y):
        return _t(x) * _t(y)

    @staticmethod
    def op_Div(a, x, y):
        x, y = _t(x), _t(y)
        if x.dtype.is_floating_point:
            return x / y
        return torch.div(x, y, rounding_mode="trunc")

    @staticmethod
    def op_Max(a, *xs):
        out = _t(xs[0])
        for x in xs[1:]:
            out = torch.maximum(out, _t(x))
        return out

    @staticmethod
    def op_Min(a, *xs):
        out = _t(xs[0])
        for x in xs[1:]:
            out = torch.minimum(out, _t(x))
        return out

    @staticmethod
    def op_Pow(a, x, y):
        x = _t(x)
        return torch.pow(x, _t(y)).to(x.dtype)

    @staticmethod
    def op_Mod(a, x, y):
        fn = torch.fmod if a.get("fmod", 0) else torch.remainder
        return fn(_t(x), _t(y))

    @staticmethod
    def op_Relu(a, x):
        return torch.relu(_t(x))

    @staticmethod
    def op_Sigmoid(a, x):
        return torch.sigmoid(_t(x))

    @staticmethod
    def op_Exp(a, x):
        return torch.exp(_t(x))

    @staticmethod
    def op_Log(a, x):
        return torch.log(_t(x))

    @staticmethod
    def op_Tanh(a, x):
        return torch.tanh(_t(x))

    @staticmethod
    def op_Sqrt(a, x):
        return torch.sqrt(_t(x))

    @staticmethod
    def op_Reciprocal(a, x):
        return torch.reciprocal(_t(x))

    @staticmethod
    def op_Neg(a, x):
        return -_t(x)

    @staticmethod
    def op_Abs(a, x):
        return torch.abs(_t(x))

    @staticmethod
    def op_Sign(a, x):
        return torch.sign(_t(x))

    @staticmethod
    def op_Floor(a, x):
        return torch.floor(_t(x))

    @staticmethod
    def op_Ceil(a, x):
        return torch.ceil(_t(x))

    @staticmethod
    def op_Round(a, x):
        return torch.round(_t(x))  # half-to-even, matching ONNX Round

    @staticmethod
    def op_Erf(a, x):
        return torch.erf(_t(x))

    @staticmethod
    def op_Clip(a, x, lo=None, hi=None):
        x = _t(x)
        if lo is not None:
            x = torch.maximum(x, _t(lo).to(x.dtype))
        if hi is not None:
            x = torch.minimum(x, _t(hi).to(x.dtype))
        return x

    @staticmethod
    def op_Cast(a, x):
        np_dt = np.dtype(ONNX_TO_NP[a["to"]])
        return _t(x).to(_NP_TO_TORCH[np_dt.name])

    @staticmethod
    def op_Identity(a, x):
        return x

    # --- comparison / logic ---
    @staticmethod
    def op_Equal(a, x, y):
        return _t(x) == _t(y)

    @staticmethod
    def op_Less(a, x, y):
        return _t(x) < _t(y)

    @staticmethod
    def op_LessOrEqual(a, x, y):
        return _t(x) <= _t(y)

    @staticmethod
    def op_Greater(a, x, y):
        return _t(x) > _t(y)

    @staticmethod
    def op_GreaterOrEqual(a, x, y):
        return _t(x) >= _t(y)

    @staticmethod
    def op_Not(a, x):
        return ~_t(x)

    @staticmethod
    def op_And(a, x, y):
        return _t(x) & _t(y)

    @staticmethod
    def op_Or(a, x, y):
        return _t(x) | _t(y)

    @staticmethod
    def op_Where(a, c, x, y):
        return torch.where(_t(c), _t(x), _t(y))

    # --- shape ---
    @staticmethod
    def op_Shape(a, x):
        # static under trace: emit the shape as a numpy constant so
        # downstream shape math constant-folds
        return np.asarray(tuple(x.shape), np.int64)

    @staticmethod
    def op_Reshape(a, x, shape):
        return _t(x).reshape([int(s) for s in _const(shape, "Reshape target")])

    @staticmethod
    def op_Transpose(a, x):
        return _t(x).permute(tuple(a["perm"]))

    @staticmethod
    def op_Concat(a, *xs):
        return torch.cat([_t(x) for x in xs], dim=a["axis"])

    @staticmethod
    def op_Expand(a, x, shape):
        x = _t(x)
        target = np.broadcast_shapes(
            tuple(x.shape),
            tuple(int(s) for s in _const(shape, "Expand target")),
        )
        return x.expand(target)

    @staticmethod
    def op_Split(a, x, split=None):
        x = _t(x)
        axis = a.get("axis", 0)
        if split is None:
            n = a["num_outputs"]
            sizes = [x.shape[axis] // n] * n
        else:
            sizes = [int(s) for s in _const(split, "Split sizes")]
        return tuple(torch.split(x, sizes, dim=axis))

    @staticmethod
    def op_Slice(a, x, starts, ends, axes=None, steps=None):
        # same bound normalization as the numpy oracle (onnx_numpy._slice)
        x = _t(x)
        starts = _const(starts, "Slice starts")
        ends = _const(ends, "Slice ends")
        nd = x.dim()
        ax = (
            list(range(len(starts)))
            if axes is None
            else [int(v) % nd for v in _const(axes, "Slice axes")]
        )
        sp = (
            [1] * len(starts)
            if steps is None
            else [int(v) for v in _const(steps, "Slice steps")]
        )
        i64max, i64min = np.iinfo(np.int64).max, np.iinfo(np.int64).min
        sl = [slice(None)] * nd
        for st, en, axi, step in zip(starts, ends, ax, sp):
            st, en, step = int(st), int(en), int(step)
            dim = x.shape[axi]
            if step > 0:
                st = min(st + dim if st < 0 else st, dim)
                en = min(en + dim if en < 0 else en, dim) if en < i64max else dim
                sl[axi] = slice(st, en, step)
            else:
                st = st + dim if st < 0 else min(st, dim - 1)
                en = None if en <= i64min + dim else (en + dim if en < 0 else en)
                sl[axi] = slice(st, en, step)
        if any(s.step is not None and s.step < 0 for s in sl if isinstance(s, slice)):
            # torch lacks negative-step slicing; realize via flip
            for axi, s in enumerate(sl):
                if isinstance(s, slice) and s.step is not None and s.step < 0:
                    x = torch.flip(x, dims=(axi,))
                    dim = x.shape[axi]
                    st = dim - 1 - (s.start if s.start is not None else dim - 1)
                    en = dim if s.stop is None else dim - 1 - s.stop
                    sl[axi] = slice(st, en, -s.step)
        return x[tuple(sl)]

    @staticmethod
    def op_Pad(a, x, pads, value=None):
        x = _t(x)
        nd = x.dim()
        p = [int(v) for v in _const(pads, "Pad widths")]
        flat: List[int] = []
        for i in range(nd - 1, -1, -1):  # F.pad: last dim first
            flat += [p[i], p[i + nd]]
        cv = 0.0 if value is None else float(np.asarray(value).item())
        return F.pad(x, flat, value=cv)

    @staticmethod
    def op_Unsqueeze(a, x, axes=None):
        x = _t(x)
        ax = a.get("axes") if axes is None else _const(axes, "axes")
        for v in sorted(int(i) for i in np.atleast_1d(ax)):
            x = x.unsqueeze(v)
        return x

    @staticmethod
    def op_Squeeze(a, x, axes=None):
        x = _t(x)
        ax = a.get("axes") if axes is None else _const(axes, "axes")
        if ax is None:
            return x.squeeze()
        for v in sorted((int(i) % x.dim() for i in np.atleast_1d(ax)), reverse=True):
            x = x.squeeze(v)
        return x

    # --- reductions ---
    @staticmethod
    def op_ReduceMax(a, x):
        x = _t(x)
        ax = _axes(a, a.get("axes"), None)
        keep = bool(a.get("keepdims", 1))
        return torch.amax(x, dim=ax, keepdim=keep) if ax else (
            x.max() if not keep else x.max().reshape([1] * x.dim())
        )

    @staticmethod
    def op_ReduceMin(a, x):
        x = _t(x)
        ax = _axes(a, a.get("axes"), None)
        keep = bool(a.get("keepdims", 1))
        return torch.amin(x, dim=ax, keepdim=keep) if ax else (
            x.min() if not keep else x.min().reshape([1] * x.dim())
        )

    @staticmethod
    def op_ReduceSum(a, x, axes=None):
        x = _t(x)
        ax = _axes(a, a.get("axes"), axes)
        keep = bool(a.get("keepdims", 1))
        if ax is None:
            return x.sum() if not keep else x.sum().reshape([1] * x.dim())
        return x.sum(dim=ax, keepdim=keep)

    @staticmethod
    def op_ReduceMean(a, x, axes=None):
        x = _t(x)
        ax = _axes(a, a.get("axes"), axes)
        keep = bool(a.get("keepdims", 1))
        if ax is None:
            return x.mean() if not keep else x.mean().reshape([1] * x.dim())
        return x.mean(dim=ax, keepdim=keep)

    @staticmethod
    def op_ArgMax(a, x):
        return torch.argmax(
            _t(x), dim=a.get("axis", 0), keepdim=bool(a.get("keepdims", 1))
        )

    @staticmethod
    def op_Softmax(a, x):
        return torch.softmax(_t(x), dim=a.get("axis", -1))

    # --- gather family ---
    @staticmethod
    def op_Gather(a, data, indices):
        data = _t(data)
        axis = a.get("axis", 0) % data.dim()
        idx = _t(indices).long()
        flat = data.index_select(axis, idx.reshape(-1))
        shape = (
            tuple(data.shape[:axis]) + tuple(idx.shape) + tuple(data.shape[axis + 1:])
        )
        return flat.reshape(shape)

    @staticmethod
    def op_GatherND(a, data, indices):
        if a.get("batch_dims", 0):
            raise NotImplementedError("GatherND batch_dims")
        data, idx = _t(data), _t(indices).long()
        parts = tuple(idx[..., i] for i in range(idx.shape[-1]))
        return data[parts]

    @staticmethod
    def op_GatherElements(a, data, indices):
        data = _t(data)
        return torch.gather(data, a.get("axis", 0), _t(indices).long())

    @staticmethod
    def op_TopK(a, x, k):
        x = _t(x)
        k = int(np.asarray(_const(k, "TopK k")).reshape(-1)[0])
        vals, idx = torch.topk(
            x, k, dim=a.get("axis", -1), largest=bool(a.get("largest", 1)),
            sorted=True,
        )
        return vals, idx.long()

    @staticmethod
    def op_NonMaxSuppression(a, boxes, scores, max_out=None, iou_th=None, score_th=None):
        """The ONNX op (the numpy interpreter's semantics: each (batch, class)
        row stable-sorted by descending score, greedy, corner order-agnostic)
        through the port's keep, ``yolov6::greedy_nms``: the CUDA kernel on
        the card. Each (batch, class) pair is one row of the keep, its
        candidates in score order carry strictly decreasing positive ranks
        (the op's precondition), those not above ``score_th`` rank 0.
        Returns ``selected_indices [S, 3]`` int64 (batch, class, box)."""
        from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms_op

        def scalar(v, default):
            return default if v is None else float(np.asarray(_const(v, "NMS operand"))
                                                    .reshape(-1)[0])

        max_out, iou_th = int(scalar(max_out, 0)), scalar(iou_th, 0.0)
        boxes, scores = _t(boxes).float(), _t(scores).float()
        B, C, N = scores.shape
        if a.get("center_point_box", 0):
            xy, wh = boxes[..., :2], boxes[..., 2:]
            boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
        boxes = torch.cat([torch.minimum(boxes[..., :2], boxes[..., 2:]),
                           torch.maximum(boxes[..., :2], boxes[..., 2:])], -1)
        sc, order = torch.sort(scores.reshape(B * C, N), dim=1, descending=True, stable=True)
        rank = torch.arange(N, 0, -1, dtype=torch.float32, device=sc.device).expand(B * C, N)
        if score_th is not None:
            rank = torch.where(sc > scalar(score_th, 0.0), rank, 0.0)
        rows = torch.arange(B, device=sc.device).repeat_interleave(C)
        row_boxes = boxes[rows[:, None], order].contiguous()
        idx, valid = greedy_nms_op(row_boxes, rank.contiguous(), min(max_out, N) if max_out
                                   else N, iou_th, True)
        r, step = valid.nonzero(as_tuple=True)
        box = order.gather(1, idx.long())[r, step]
        return torch.stack([r // C, r % C, box], 1).long()

    # --- linear / conv / pool ---
    @staticmethod
    def op_MatMul(a, x, y):
        return torch.matmul(_t(x), _t(y))

    @staticmethod
    def op_Gemm(a, x, y, c=None):
        x, y = _t(x), _t(y)
        out = torch.matmul(
            x.t() if a.get("transA") else x, y.t() if a.get("transB") else y
        ) * a.get("alpha", 1.0)
        if c is not None:
            out = out + _t(c) * a.get("beta", 1.0)
        return out

    @staticmethod
    def op_Conv(a, x, w, b=None):
        x, w = _t(x), _t(w)
        strides = [int(s) for s in a.get("strides", [1, 1])]
        pads = [int(p) for p in a.get("pads", [0, 0, 0, 0])]
        dil = [int(d) for d in a.get("dilations", [1, 1])]
        group = int(a.get("group", 1))
        if pads[:2] != pads[2:]:
            x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
            padding = (0, 0)
        else:
            padding = (pads[0], pads[1])
        return F.conv2d(
            x, w, None if b is None else _t(b), stride=tuple(strides),
            padding=padding, dilation=tuple(dil), groups=group,
        )

    @staticmethod
    def op_MaxPool(a, x):
        x = _t(x)
        kernel = [int(k) for k in a["kernel_shape"]]
        strides = [int(s) for s in a.get("strides", [1] * len(kernel))]
        pads = [int(p) for p in a.get("pads", [0, 0, 0, 0])]
        if pads[:2] != pads[2:] or any(p > k // 2 for p, k in zip(pads[:2], kernel)):
            x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]), value=float("-inf"))
            padding = (0, 0)
        else:
            padding = (pads[0], pads[1])
        return F.max_pool2d(
            x, tuple(kernel), stride=tuple(strides), padding=padding
        )

    # --- quantization (QDQ exports execute as fake-quant, like ORT CPU) ---
    @staticmethod
    def _axis_shape(scale, x, axis):
        s = _t(scale)
        if s.dim() == 0:
            return s
        shape = [1] * x.dim()
        shape[axis] = -1
        return s.reshape(shape)

    @staticmethod
    def op_QuantizeLinear(a, x, scale, zp=None):
        x = _t(x)
        s = _TorchOps._axis_shape(scale, x, a.get("axis", 1))
        np_dt = np.int8 if zp is None else np.asarray(zp).dtype
        info = np.iinfo(np_dt)
        z = 0 if zp is None else _TorchOps._axis_shape(zp, x, a.get("axis", 1))
        q = torch.round(x / s) + z
        return torch.clamp(q, info.min, info.max).to(
            _NP_TO_TORCH[np.dtype(np_dt).name]
        )

    @staticmethod
    def op_DequantizeLinear(a, x, scale, zp=None):
        x = _t(x)
        axis = a.get("axis", 1)
        s = _TorchOps._axis_shape(scale, x, axis)
        z = 0 if zp is None else _TorchOps._axis_shape(zp, x, axis)
        return (x.float() - z) * s


_NP_TO_TORCH = {
        "float32": torch.float32,
        "float64": torch.float64,
        "float16": torch.float16,
        "int64": torch.int64,
        "int32": torch.int32,
        "int8": torch.int8,
        "uint8": torch.uint8,
        "bool": torch.bool,
    }


class OnnxTorchModule(torch.nn.Module):
    """Execute a parsed ONNX graph with torch ops — traceable (a copy of the
    JAX package's, which also runs on the device of its inputs: a CUDA
    input puts every constant it touches on that device, once).

    Constant-only nodes fold through the numpy interpreter so shape
    operands stay static; everything downstream of a traced input runs
    as torch ops (and records into the trace).
    """

    def __init__(self, model: bytes | ParsedModel):
        super().__init__()
        self.parsed = (
            parse_model(model) if isinstance(model, (bytes, bytearray)) else model
        )
        self.input_names = [n for n, _, _ in self.parsed.inputs]
        self.output_names = [n for n, _, _ in self.parsed.outputs]
        self._np = OnnxRunner(self.parsed)
        self._on_device: Dict[object, Dict[int, "torch.Tensor"]] = {}

    def forward(self, *args):
        dev = next((a.device for a in args if torch.is_tensor(a)), None)
        if dev is not None and dev.type != "cpu" and dev not in self._on_device:
            self._on_device[dev] = {
                id(a): torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in self.parsed.initializers.values()}
        _Placement.device = dev
        _Placement.cache = self._on_device.get(dev, {})
        try:
            return self._run(*args)
        finally:
            _Placement.device, _Placement.cache = None, {}

    def _run(self, *args):
        env: Dict[str, object] = dict(self.parsed.initializers)
        for name, x in zip(self.input_names, args):
            env[name] = x
        for node in self.parsed.nodes:
            ins = [env[i] if i else None for i in node.inputs]
            if not any(torch.is_tensor(v) for v in ins):
                fn = getattr(self._np, f"op_{node.op_type}", None)
                if fn is None:
                    raise NotImplementedError(f"ONNX op '{node.op_type}' (const)")
                outs = fn(node.attrs, *ins)
            else:
                fn = getattr(_TorchOps, f"op_{node.op_type}", None)
                if fn is None:
                    raise NotImplementedError(f"ONNX op '{node.op_type}' (torch)")
                outs = fn(node.attrs, *ins)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for name, val in zip(node.outputs, outs):
                env[name] = val
        outs = tuple(_t(env[n]) for n in self.output_names)
        return outs[0] if len(outs) == 1 else outs


class DeployForward(torch.nn.Module):
    """The deploy model plus decode over NHWC images: ``[b, A, 5+nc]`` in
    fp32 (the contract of the exported TorchScript and ONNX graphs). The
    images go to ``dtype`` (the model's); ``with_preprocess`` folds BGR->RGB
    and /255 in, for uint8 images."""

    def __init__(self, model, with_preprocess: bool = False, dtype=torch.float32):
        super().__init__()
        self.model, self.with_preprocess, self.dtype = model, with_preprocess, dtype

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        if self.with_preprocess:
            x = x.flip(1) / 255.0  # BGR -> RGB, normalize
        head_out, _ = self.model(x)
        return self.model.decode(head_out)


def export_torchscript(model, example_inputs: Sequence, output: Optional[str] = None):
    """Trace the deploy ``model`` plus decode (``DeployForward``) with
    ``torch.jit.trace`` on ``example_inputs`` (NHWC images, tensors or
    numpy arrays) and save it to ``output`` if given. Returns the traced
    ``torch.jit.ScriptModule``."""
    module = model if isinstance(model, DeployForward) else DeployForward(model)
    examples = tuple(torch.as_tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray)
                     else x for x in example_inputs)
    with torch.no_grad():
        traced = torch.jit.trace(module.eval(), examples)
    if output:
        traced.save(output)
    return traced
