"""NCNN ``.param``/``.bin`` emitter for the lite model family (port of
yolov6_tpu/export/ncnn_export.py, which walks the flax modules: this one
walks the port's, models/efficientrep.py::Lite_EffiBackbone,
models/reppan.py::Lite_EffiNeck and models/heads/effidehead_lite.py, and
writes the same files byte for byte from the same weights).

The reference ships these artifacts for its Android app
(reference: deploy/NCNN/Android/app/src/main/assets/yolov6-lite-*.param,
consumed by yolo.cpp:121-416) and produces them with the external PNNX
converter from a TorchScript trace (reference: deploy/NCNN/README.md).
Here the emitter walks the deploy-mode lite modules directly and writes the
same graph the PNNX pipeline emits:

- identical op inventory (the JAX package checks it against the shipped
  assets): Convolution / ConvolutionDepthWise with
  separate HardSwish layers, SE as GAP+Conv(+fused ReLU)+Conv+HardSigmoid+
  BinaryOp(mul), shuffle blocks as Slice/Concat/ShuffleChannel, Interp
  nearest-2x upsampling, per-level head outputs as
  Concat(Conv[fused sigmoid] cls, Conv reg) named out0..out3 (stride 8<<i —
  the contract of deploy/NCNN/infer-ncnn-model.py:yolov6_decode);
- the ncnn bin format: a 4-byte quantize tag per conv weight array
  (0 = raw fp32, 0x01306B47 = fp16 + pad-to-4), raw fp32 bias.

Blobs consumed more than once get an explicit ``Split`` layer (an ncnn
graph invariant), inserted automatically at finalize.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

FP16_TAG = 0x01306B47


def _fmt(v) -> str:
    if isinstance(v, (list, tuple, np.ndarray)):
        vals = list(v)
        return f"{len(vals)}," + ",".join(_fmt(x) for x in vals)
    if isinstance(v, float):
        return f"{v:e}"
    return str(int(v))


class NcnnGraph:
    """Ordered layer list + blob bookkeeping + the two writers."""

    def __init__(self):
        self.layers: List[dict] = []
        self._n = 0

    def _blob(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def add(
        self,
        op: str,
        name: str,
        inputs: Sequence[str],
        n_out: int = 1,
        params: Optional[Dict[int, Any]] = None,
        weights: Sequence[np.ndarray] = (),
        out_names: Optional[Sequence[str]] = None,
    ) -> Any:
        outs = list(out_names) if out_names else [self._blob(name) for _ in range(n_out)]
        assert len(outs) == n_out
        self.layers.append(dict(
            op=op, name=name, inputs=list(inputs), outputs=outs,
            params=dict(params or {}), weights=list(weights),
        ))
        return outs[0] if n_out == 1 else outs

    # ----------------------------------------------------------- finalize

    def finalize(self, graph_outputs: Sequence[str]) -> None:
        """Insert ncnn Split layers after any blob with >1 consumer and
        rewire consumers in first-use order (the PNNX/onnx2ncnn invariant:
        every blob feeds exactly one layer)."""
        consumers: Dict[str, List[Tuple[int, int]]] = {}
        for li, layer in enumerate(self.layers):
            for ii, b in enumerate(layer["inputs"]):
                consumers.setdefault(b, []).append((li, ii))
        new_layers: List[dict] = []
        n_split = 0
        rewire: Dict[Tuple[int, int], str] = {}
        for li, layer in enumerate(self.layers):
            new_layers.append(layer)
            for b in layer["outputs"]:
                cons = consumers.get(b, [])
                if len(cons) > 1 and b not in graph_outputs:
                    outs = [f"{b}_split{k}" for k in range(len(cons))]
                    new_layers.append(dict(
                        op="Split", name=f"splitncnn_{n_split}",
                        inputs=[b], outputs=outs, params={}, weights=[],
                    ))
                    n_split += 1
                    for k, (cli, cii) in enumerate(cons):
                        rewire[(cli, cii)] = outs[k]
        for li, layer in enumerate(self.layers):
            for ii in range(len(layer["inputs"])):
                if (li, ii) in rewire:
                    layer["inputs"][ii] = rewire[(li, ii)]
        self.layers = new_layers

    # ------------------------------------------------------------ writers

    def write_param(self, path: str) -> None:
        blobs = []
        for layer in self.layers:
            blobs.extend(layer["outputs"])
        lines = ["7767517", f"{len(self.layers)} {len(blobs)}"]
        for layer in self.layers:
            row = [f"{layer['op']:<24} {layer['name']:<24} "
                   f"{len(layer['inputs'])} {len(layer['outputs'])}"]
            row += layer["inputs"] + layer["outputs"]
            # array params (negative 233xx ids) first, then scalars ascending
            keys = sorted(layer["params"], key=lambda k: (k >= 0, abs(k)))
            row += [f"{k}={_fmt(layer['params'][k])}" for k in keys]
            lines.append(" ".join(row))
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    def write_bin(self, path: str, fp16: bool = True) -> None:
        with open(path, "wb") as f:
            for layer in self.layers:
                if not layer["weights"]:
                    continue
                # conv layers: [weight, bias?] — weight carries the tag
                weight = np.asarray(layer["weights"][0], np.float32).ravel()
                if fp16:
                    f.write(struct.pack("<I", FP16_TAG))
                    h = weight.astype(np.float16).tobytes()
                    f.write(h)
                    if len(h) % 4:
                        f.write(b"\x00" * (4 - len(h) % 4))
                else:
                    f.write(struct.pack("<I", 0))
                    f.write(weight.tobytes())
                for extra in layer["weights"][1:]:
                    f.write(np.asarray(extra, np.float32).ravel().tobytes())


# --------------------------------------------------------------------- ops

def _p(model, path: str) -> dict:
    """The conv at the JAX module ``path`` of ``model`` (a ``/``-separated
    path is the dotted torch module name): its kernel as flax's HWIO
    ``[kh, kw, cin/groups, cout]``, its bias and its groups."""
    conv = model.get_submodule(path.replace("/", "."))
    w = conv.weight.detach().float().cpu().numpy()
    return dict(kernel=np.transpose(w, (2, 3, 1, 0)),
                bias=conv.bias.detach().float().cpu().numpy(), groups=conv.groups)


def _conv(g: NcnnGraph, name: str, x: str, kernel: np.ndarray,
          bias: np.ndarray, stride: int = 1, pad: Optional[int] = None,
          groups: int = 1, act: int = 0) -> str:
    """kernel is flax HWIO [kh, kw, cin/groups, cout]."""
    kh, kw, cing, cout = kernel.shape
    w = np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))  # OIHW
    if pad is None:
        pad = kh // 2
    params = {0: cout, 1: kw, 11: kh, 2: 1, 12: 1, 3: stride, 13: stride,
              4: pad, 14: pad, 5: 1, 6: int(w.size)}
    if act:
        params[9] = act
    op = "Convolution"
    if groups > 1:
        op = "ConvolutionDepthWise"
        params[7] = groups
    return g.add(op, name, [x], params=params,
                 weights=[w, np.asarray(bias, np.float32)])


def _hswish(g: NcnnGraph, name: str, x: str) -> str:
    return g.add("HardSwish", name, [x], params={0: 1.0 / 6.0, 1: 0.5})


def _conv_module(g: NcnnGraph, params, prefix: str, x: str, stride: int,
                 act: str = "hardswish", pad: Optional[int] = None) -> str:
    """Deploy ConvModule (= ConvBN*/ConvBNHS '.block'): conv + activation."""
    conv = _p(params, prefix + "/conv")
    name = prefix.replace("/", ".")
    fused = {"relu": 1, "sigmoid": 4}.get(act, 0)
    y = _conv(g, name, x, conv["kernel"], conv["bias"], stride=stride,
              pad=pad, groups=conv["groups"], act=fused)
    if act == "hardswish":
        y = _hswish(g, name + ".hs", y)
    return y


def _se(g: NcnnGraph, params, prefix: str, x: str) -> str:
    """SEBlock (layers/common.py:SEBlock): GAP -> 1x1(+ReLU) -> 1x1 ->
    HardSigmoid -> channel-wise mul."""
    name = prefix.replace("/", ".")
    w = g.add("Pooling", name + ".gap", [x], params={0: 1, 4: 1})
    c1 = _p(params, prefix + "/conv1")
    w = _conv(g, name + ".conv1", w, c1["kernel"], c1["bias"], act=1)
    c2 = _p(params, prefix + "/conv2")
    w = _conv(g, name + ".conv2", w, c2["kernel"], c2["bias"])
    w = g.add("HardSigmoid", name + ".hsig", [w],
              params={0: 1.0 / 6.0, 1: 0.5})
    return g.add("BinaryOp", name + ".mul", [x, w], params={0: 2})


def _dp_block(g: NcnnGraph, params, prefix: str, x: str, channels: int,
              kernel: int, stride: int) -> str:
    """DPBlock deploy: dw conv + HS + pw conv + HS (layers/common.py:DPBlock)."""
    dw = _p(params, prefix + "/conv_dw_1")
    name = prefix.replace("/", ".")
    x = _conv(g, name + ".dw", x, dw["kernel"], dw["bias"], stride=stride,
              pad=(kernel - 1) // 2, groups=dw["groups"])
    x = _hswish(g, name + ".dw.hs", x)
    pw = _p(params, prefix + "/conv_pw_1")
    x = _conv(g, name + ".pw", x, pw["kernel"], pw["bias"])
    return _hswish(g, name + ".pw.hs", x)


def _effiblock_s1(g: NcnnGraph, params, prefix: str, x: str, in_ch: int) -> str:
    name = prefix.replace("/", ".")
    half = in_ch // 2
    x1, x2 = g.add("Slice", name + ".split", [x], n_out=2,
                   params={-23300: [half, in_ch - half], 1: 0})
    y = _conv_module(g, params, prefix + "/conv_pw_1/block", x2, 1)
    dw = _p(params, prefix + "/conv_dw_1/block/conv")
    y = _conv(g, name + ".dw1", y, dw["kernel"], dw["bias"], stride=1,
              groups=dw["groups"])
    y = _se(g, params, prefix + "/se", y)
    y = _conv_module(g, params, prefix + "/conv_1/block", y, 1)
    out = g.add("Concat", name + ".cat", [x1, y], params={0: 0})
    return g.add("ShuffleChannel", name + ".shuffle", [out],
                 params={0: 2, 1: 0})


def _effiblock_s2(g: NcnnGraph, params, prefix: str, x: str) -> str:
    name = prefix.replace("/", ".")
    dw1 = _p(params, prefix + "/conv_dw_1/block/conv")
    x1 = _conv(g, name + ".dw1", x, dw1["kernel"], dw1["bias"], stride=2,
               groups=dw1["groups"])
    x1 = _conv_module(g, params, prefix + "/conv_1/block", x1, 1)
    x2 = _conv_module(g, params, prefix + "/conv_pw_2/block", x, 1)
    dw2 = _p(params, prefix + "/conv_dw_2/block/conv")
    x2 = _conv(g, name + ".dw2", x2, dw2["kernel"], dw2["bias"], stride=2,
               groups=dw2["groups"])
    x2 = _se(g, params, prefix + "/se", x2)
    x2 = _conv_module(g, params, prefix + "/conv_2/block", x2, 1)
    out = g.add("Concat", name + ".cat", [x1, x2], params={0: 0})
    out = _conv_module(g, params, prefix + "/conv_dw_3/block", out, 1)
    return _conv_module(g, params, prefix + "/conv_pw_3/block", out, 1)


def _darknet_block(g: NcnnGraph, params, prefix: str, x: str, out_ch: int,
                   kernel: int) -> str:
    x = _conv_module(g, params, prefix + "/conv_1/block", x, 1)
    return _dp_block(g, params, prefix + "/conv_2", x, out_ch, kernel, 1)


def _csp_block(g: NcnnGraph, params, prefix: str, x: str, out_ch: int,
               kernel: int, expand: float = 0.5) -> str:
    name = prefix.replace("/", ".")
    mid = int(out_ch * expand)
    x1 = _conv_module(g, params, prefix + "/conv_1/block", x, 1)
    x1 = _darknet_block(g, params, prefix + "/blocks", x1, mid, kernel)
    x2 = _conv_module(g, params, prefix + "/conv_2/block", x, 1)
    cat = g.add("Concat", name + ".cat", [x1, x2], params={0: 0})
    return _conv_module(g, params, prefix + "/conv_3/block", cat, 1)


def _interp2x(g: NcnnGraph, name: str, x: str) -> str:
    return g.add("Interp", name, [x], params={0: 1, 1: 2.0, 2: 2.0, 6: 0})


# ----------------------------------------------------------------- model

def build_ncnn_graph(model) -> NcnnGraph:
    """Walk a deploy-mode lite ``Model`` (models/yolo.py::_build_lite) and
    emit the ncnn graph. Mirrors the module call graphs exactly — any change
    to the lite modules shows up as an oracle mismatch against the head maps
    in tests/test_torch_ncnn_export.py. Widths and repeats are read off the
    modules (the flax modules carry them as attributes)."""
    bb = model.backbone
    neck = model.neck
    head = model.detect
    if type(bb).__name__ != "Lite_EffiBackbone":
        raise ValueError("NCNN export covers the lite family only (the "
                         "reference ships only lite NCNN assets)")
    params = model
    g = NcnnGraph()
    x = g.add("Input", "in0", [], out_names=["in0"])

    # backbone (models/efficientrep.py:Lite_EffiBackbone)
    stages = [getattr(bb, f"lite_effiblock_{i + 1}") for i in range(4)]
    out_ch = [24] + [int(st[0].conv_pw_3.block.conv.out_channels) for st in stages]
    # a conv's groups come from its module (the flax emitter passes widths)
    x = _conv_module(g, params, "backbone/conv_0/block", x, 2)
    feats = []
    for stage in range(4):
        for i in range(len(stages[stage])):
            prefix = f"backbone/lite_effiblock_{stage + 1}.{i}"
            if i == 0:
                x = _effiblock_s2(g, params, prefix, x)
            else:
                x = _effiblock_s1(g, params, prefix, x, out_ch[stage + 1])
        if stage >= 1:
            feats.append(x)

    # neck (models/reppan.py:Lite_EffiNeck)
    uc = int(neck.reduce_layer0.block.conv.out_channels)
    x2, x1, x0 = feats
    fpn_out0 = _conv_module(g, params, "neck/reduce_layer0/block", x0, 1)
    x1 = _conv_module(g, params, "neck/reduce_layer1/block", x1, 1)
    x2 = _conv_module(g, params, "neck/reduce_layer2/block", x2, 1)
    up0 = _interp2x(g, "neck.up0", fpn_out0)
    cat0 = g.add("Concat", "neck.cat_p4", [up0, x1], params={0: 0})
    f_out1 = _csp_block(g, params, "neck/Csp_p4", cat0, uc, 5)
    up1 = _interp2x(g, "neck.up1", f_out1)
    cat1 = g.add("Concat", "neck.cat_p3", [up1, x2], params={0: 0})
    pan_out3 = _csp_block(g, params, "neck/Csp_p3", cat1, uc, 5)
    down1 = _dp_block(g, params, "neck/downsample2", pan_out3, uc, 5, 2)
    cat2 = g.add("Concat", "neck.cat_n3", [down1, f_out1], params={0: 0})
    pan_out2 = _csp_block(g, params, "neck/Csp_n3", cat2, uc, 5)
    down0 = _dp_block(g, params, "neck/downsample1", pan_out2, uc, 5, 2)
    cat3 = g.add("Concat", "neck.cat_n4", [down0, fpn_out0], params={0: 0})
    pan_out1 = _csp_block(g, params, "neck/Csp_n4", cat3, uc, 5)
    top = _dp_block(g, params, "neck/p6_conv_1", fpn_out0, uc, 5, 2)
    down = _dp_block(g, params, "neck/p6_conv_2", pan_out1, uc, 5, 2)
    pan_out0 = g.add("BinaryOp", "neck.p6_add", [top, down], params={0: 0})

    # head (models/heads/effidehead_lite.py:DetectLite); out{i} = stride 8<<i,
    # channels [sigmoid(cls) ; reg] — deploy/NCNN/infer-ncnn-model.py:108-117
    levels = [pan_out3, pan_out2, pan_out1, pan_out0][: len(head.stems)]
    outs = []
    for i, x in enumerate(levels):
        s = _dp_block(g, params, f"detect/stems.{i}", x, uc, 5, 1)
        cls_f = _dp_block(g, params, f"detect/cls_convs.{i}", s, uc, 5, 1)
        cp = _p(params, f"detect/cls_preds.{i}")
        cls = _conv(g, f"detect.cls_preds.{i}", cls_f, cp["kernel"],
                    cp["bias"], act=4)
        reg_f = _dp_block(g, params, f"detect/reg_convs.{i}", s, uc, 5, 1)
        rp = _p(params, f"detect/reg_preds.{i}")
        reg = _conv(g, f"detect.reg_preds.{i}", reg_f, rp["kernel"],
                    rp["bias"])
        g.add("Concat", f"detect.out{i}", [cls, reg], params={0: 0},
              out_names=[f"out{i}"])
        outs.append(f"out{i}")

    g.finalize(outs)
    return g


def export_ncnn(model, output_prefix: str, fp16: bool = True) -> Tuple[str, str]:
    """Emit ``<prefix>.param`` + ``<prefix>.bin`` of the deploy lite
    ``model``. Returns the two paths."""
    g = build_ncnn_graph(model)
    param_path = output_prefix + ".param"
    bin_path = output_prefix + ".bin"
    g.write_param(param_path)
    g.write_bin(bin_path, fp16=fp16)
    return param_path, bin_path
