"""Minimal numpy executor for ncnn ``.param``/``.bin`` graphs — the

A copy of yolov6_tpu/export/ncnn_numpy.py, framework-free.
correctness oracle for export/ncnn_export.py (the repo pattern: every
emitted artifact format gets an independent interpreter, like
onnx_numpy.OnnxRunner for the ONNX writer). Covers exactly the op set the
lite models use (the same inventory as the reference's shipped Android
assets): Convolution, ConvolutionDepthWise, HardSwish, HardSigmoid, Split,
Slice, ShuffleChannel, Concat, Pooling (global-avg), BinaryOp (mul/add),
Interp (nearest 2x), Input.

Semantics follow ncnn's (src/layer/*.cpp): blobs are CHW (no batch dim),
fp16 weight arrays are tagged 0x01306B47 and 4-byte aligned, bias is raw
fp32.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

from yolov6_tpu_torch.export.ncnn_export import FP16_TAG
from yolov6_tpu_torch.export.onnx_numpy import _conv2d


def parse_param(path: str) -> List[dict]:
    with open(path) as f:
        magic = f.readline().strip()
        assert magic == "7767517", f"bad ncnn magic {magic}"
        n_layers, n_blobs = map(int, f.readline().split())
        layers = []
        for _ in range(n_layers):
            parts = f.readline().split()
            op, name, n_in, n_out = parts[0], parts[1], int(parts[2]), int(parts[3])
            inputs = parts[4 : 4 + n_in]
            outputs = parts[4 + n_in : 4 + n_in + n_out]
            params: Dict[int, object] = {}
            for tok in parts[4 + n_in + n_out :]:
                k, v = tok.split("=", 1)
                k = int(k)
                if k <= -23300:  # array param: "count,v0,v1,..."
                    vals = v.split(",")
                    arr = [float(x) if ("." in x or "e" in x) else int(x)
                           for x in vals[1:]]
                    params[-(k + 23300)] = arr
                else:
                    params[k] = float(v) if ("." in v or "e" in v) else int(v)
            layers.append(dict(op=op, name=name, inputs=inputs,
                               outputs=outputs, params=params))
        assert len(layers) == n_layers
        blob_count = sum(len(l["outputs"]) for l in layers)
        assert blob_count == n_blobs, (blob_count, n_blobs)
    return layers


def _read_conv_weights(f, params) -> tuple:
    cout = int(params[0])
    ksize = int(params[1]) * int(params.get(11, params[1]))
    wsize = int(params[6])
    tag = struct.unpack("<I", f.read(4))[0]
    if tag == FP16_TAG:
        raw = f.read(wsize * 2)
        if (wsize * 2) % 4:
            f.read(4 - (wsize * 2) % 4)
        w = np.frombuffer(raw, np.float16).astype(np.float32)
    elif tag == 0:
        w = np.frombuffer(f.read(wsize * 4), np.float32).copy()
    else:
        raise ValueError(f"unsupported ncnn weight tag 0x{tag:08x}")
    cin_g = wsize // (cout * ksize)
    kh = int(params.get(11, params[1]))
    kw = int(params[1])
    w = w.reshape(cout, cin_g, kh, kw)
    bias = None
    if int(params.get(5, 0)):
        bias = np.frombuffer(f.read(cout * 4), np.float32).copy()
    return w, bias


class NcnnRunner:
    def __init__(self, param_path: str, bin_path: str):
        self.layers = parse_param(param_path)
        with open(bin_path, "rb") as f:
            for layer in self.layers:
                if layer["op"] in ("Convolution", "ConvolutionDepthWise"):
                    layer["w"], layer["b"] = _read_conv_weights(f, layer["params"])
            tail = f.read()
            assert not tail, f"{len(tail)} unread bytes in .bin"

    def __call__(self, in0: np.ndarray) -> Dict[str, np.ndarray]:
        """in0: CHW fp32. Returns every blob (incl. out0..out3)."""
        blobs: Dict[str, np.ndarray] = {}
        for layer in self.layers:
            op, p = layer["op"], layer["params"]
            x = [blobs[b] for b in layer["inputs"]]
            if op == "Input":
                y = in0.astype(np.float32)
            elif op in ("Convolution", "ConvolutionDepthWise"):
                g = int(p.get(7, 1))
                stride = [int(p.get(13, 1)), int(p.get(3, 1))]
                pad = [int(p.get(14, 0)), int(p.get(4, 0))] * 2
                y = _conv2d(x[0][None], layer["w"], stride, pad, [1, 1], g)[0]
                if layer["b"] is not None:
                    y = y + layer["b"][:, None, None]
                act = int(p.get(9, 0))
                if act == 1:
                    y = np.maximum(y, 0.0)
                elif act == 4:
                    y = 1.0 / (1.0 + np.exp(-y))
                elif act:
                    raise NotImplementedError(f"activation {act}")
            elif op == "HardSwish":
                a, b = float(p[0]), float(p[1])
                y = x[0] * np.clip(a * x[0] + b, 0.0, 1.0)
            elif op == "HardSigmoid":
                a, b = float(p[0]), float(p[1])
                y = np.clip(a * x[0] + b, 0.0, 1.0)
            elif op == "Split":
                for out in layer["outputs"]:
                    blobs[out] = x[0]
                continue
            elif op == "Slice":
                sizes = [int(s) for s in p[0]]
                axis = int(p.get(1, 0))
                idx = np.cumsum(sizes)[:-1]
                for out, part in zip(layer["outputs"],
                                     np.split(x[0], idx, axis=axis)):
                    blobs[out] = part
                continue
            elif op == "ShuffleChannel":
                gn = int(p[0])
                c, h, w = x[0].shape
                y = x[0].reshape(gn, c // gn, h, w).swapaxes(0, 1).reshape(c, h, w)
            elif op == "Concat":
                y = np.concatenate(x, axis=int(p.get(0, 0)))
            elif op == "Pooling":
                assert int(p.get(0, 0)) == 1 and int(p.get(4, 0)) == 1
                y = x[0].mean(axis=(1, 2), keepdims=True)
            elif op == "BinaryOp":
                kind = int(p.get(0, 0))
                y = x[0] * x[1] if kind == 2 else x[0] + x[1]
            elif op == "Interp":
                assert int(p[0]) == 1  # nearest
                sh, sw = float(p[1]), float(p[2])
                assert sh == 2.0 and sw == 2.0
                y = np.repeat(np.repeat(x[0], 2, axis=1), 2, axis=2)
            else:
                raise NotImplementedError(f"ncnn op {op}")
            assert len(layer["outputs"]) == 1
            blobs[layer["outputs"][0]] = y
        return blobs
