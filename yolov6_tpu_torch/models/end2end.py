"""End-to-end serving function: preprocessing + forward + decode + NMS
(port of yolov6_tpu/models/end2end.py). Outputs follow the reference
End2End contract: (num_dets [b,1] int32, boxes [b,max_det,4],
scores [b,max_det], classes [b,max_det] int32).

The serving artifact is a ``torch.export`` program saved as ``.pt2``, where
the JAX package writes StableHLO (``export_stablehlo``): the whole serve,
NMS included, is one graph whose keep is the registered op
``yolov6::greedy_nms``, so a loaded artifact launches the CUDA kernel as the
JAX artifact carries its Pallas kernel."""

from __future__ import annotations

import copy
import os
from typing import Tuple

import torch
from torch import nn

from yolov6_tpu_torch.ops.nms import non_max_suppression
from yolov6_tpu_torch.utils.device import resolve_device


class ServeModule(nn.Module):
    """The serve as a module over NHWC images (uint8 or float):
    ``forward(images) -> (num_dets, boxes, scores, classes)``.

    ``with_preprocess`` folds BGR->RGB and /255 into the graph. The forward
    runs in ``dtype`` (the model's own, or under bf16 autocast with
    ``autocast=True``); decode and NMS run in fp32. NMS is the serve's
    (``multi_label=False``, ``max_nms`` 30000) unless given the eval
    protocol's (``Evaler.init_artifact`` evaluates such an artifact)."""

    def __init__(self, model, conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 100, with_preprocess: bool = False,
                 dtype: torch.dtype = torch.float32, autocast: bool = False,
                 multi_label: bool = False, max_nms: int = 30000):
        super().__init__()
        self.model = model
        self.conf_thres, self.iou_thres, self.max_det = conf_thres, iou_thres, max_det
        self.multi_label, self.max_nms = multi_label, max_nms
        self.with_preprocess = with_preprocess
        self.dtype = dtype
        self.autocast = autocast

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).to(self.dtype).contiguous()
        if self.with_preprocess:
            x = x.flip(1) / 255.0  # BGR -> RGB, normalize
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=self.autocast):
            head_out, _ = self.model(x)
        preds = self.model.decode(head_out)
        dets, valid = non_max_suppression(
            preds, self.conf_thres, self.iou_thres, max_det=self.max_det, max_nms=self.max_nms,
            multi_label=self.multi_label,
        )
        num_dets = valid.sum(1, keepdim=True, dtype=torch.int32)
        return num_dets, dets[..., :4], dets[..., 4], dets[..., 5].to(torch.int32)


def make_end2end_fn(
    model,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 100,
    with_preprocess: bool = False,
    half: bool = True,
    device="cuda",
):
    """Build ``serve(images)`` over uint8/float NHWC images for ``model``,
    which must already sit on ``device``.

    ``with_preprocess`` folds BGR->RGB and /255 into the function.
    ``half`` runs the model in bf16 (autocast); decode and NMS run in fp32.
    NMS keeps with the default method, as the JAX serve does: the CUDA
    kernel's tile walk on a CUDA tensor, under the rule that emits each box
    at most once (the JAX ``'tiled'`` keep; ops/nms.py)."""
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f"model is on {model_device}, serving device is {device}")
    module = ServeModule(model, conf_thres, iou_thres, max_det, with_preprocess,
                         torch.bfloat16 if half else torch.float32, autocast=half)

    @torch.inference_mode()
    def serve(images):
        return module(torch.as_tensor(images, device=device))

    return serve


def export_serve_module(model, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        max_det: int = 100, with_preprocess: bool = False,
                        half: bool = True, multi_label: bool = False,
                        max_nms: int = 30000) -> ServeModule:
    """The serve to export: ``half`` means bf16 weights and activations (a
    bf16 copy of ``model``) with decode and NMS in fp32, as the live serve
    computes them under autocast; an exported graph carries no autocast."""
    if half:
        model = copy.deepcopy(model).to(torch.bfloat16)
    return ServeModule(model, conf_thres, iou_thres, max_det, with_preprocess,
                       torch.bfloat16 if half else torch.float32,
                       multi_label=multi_label, max_nms=max_nms).eval()


def export_program(serve_module: nn.Module, batch: int, img_size: Tuple[int, int], path: str,
                   input_dtype=torch.uint8, platforms=None, shard_devices: int = 1,
                   weights=None) -> str:
    """Export ``serve_module`` (``export_serve_module``) with ``torch.export``
    over ``[batch, h, w, 3]`` images of ``input_dtype`` on the module's
    device, and save the program to ``path`` (``.pt2``; JAX:
    ``export_stablehlo``). The program holds the weights.

    Not ported, each raising: ``platforms`` (a program runs where it was
    exported and ``load_serving`` moves it), ``shard_devices`` (GSPMD
    serving, on ROADMAP's do-not-port list) and ``weights`` (the weights-as-arguments
    form exists for a TPU remote-compile size limit; ROADMAP do-not-port
    list)."""
    if platforms:
        raise NotImplementedError("platforms: a .pt2 program runs on the device it was exported "
                                  "on and load_serving(path, device) moves it; the multi-platform "
                                  "StableHLO artifact is on ROADMAP's do-not-port list")
    if shard_devices != 1:
        raise NotImplementedError("shard_devices: GSPMD serving over a device mesh (the GSPMD "
                                  "export) is on ROADMAP's do-not-port list")
    if weights is not None:
        raise NotImplementedError("weights as arguments exists for a TPU remote-compile size "
                                  "limit; it is on ROADMAP's do-not-port list")
    device = next(serve_module.parameters()).device
    example = torch.zeros((batch, img_size[0], img_size[1], 3), dtype=input_dtype, device=device)
    with torch.no_grad():
        program = torch.export.export(serve_module, (example,))
    torch.export.save(program, path)
    return path


def write_native_artifact(*args, **kwargs):
    """Not ported: the JAX package's directory for its native C++ PJRT runner
    (native/pjrt_runner.cc), which is on ROADMAP's do-not-port list."""
    raise NotImplementedError("write_native_artifact feeds the JAX package's native PJRT "
                              "runner, which is on ROADMAP's do-not-port list; serve the .pt2 "
                              "artifact with load_serving")


class _ServingArtifact:
    """A loaded ``.pt2`` serve: ``call(images)`` on ``device``, with the input
    and output specs (``in_specs``/``out_specs``: (shape, dtype) each)."""

    def __init__(self, program, device):
        self.program = program
        self.device = device
        self.module = program.module()
        self.in_specs = [(tuple(s.shape), s.dtype) for s in _placeholder_specs(program)]
        self.out_specs = [(tuple(n.meta["val"].shape), n.meta["val"].dtype)
                          for n in _output_nodes(program)]

    def call(self, images):
        with torch.no_grad():
            return self.module(torch.as_tensor(images, device=self.device))


def _placeholder_specs(program):
    user_inputs = set(program.graph_signature.user_inputs)
    return [n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder" and n.name in user_inputs]


def _output_nodes(program):
    out = next(n for n in program.graph.nodes if n.op == "output")
    return list(out.args[0])


def load_serving(path: str, device="cuda") -> _ServingArtifact:
    """Load a ``.pt2`` serving artifact onto ``device`` (default the card)
    and return an object with ``.call(images)``. The op registration
    (ops/cuda/nms_kernel.py) is imported first, so the program's keep
    resolves to the kernel on a CUDA device."""
    import yolov6_tpu_torch.ops.cuda.nms_kernel  # noqa: F401  (yolov6::greedy_nms)

    device = resolve_device(device)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    program = torch.export.load(path)
    if _placeholder_specs(program)[0].device.type != device.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return _ServingArtifact(program, device)
