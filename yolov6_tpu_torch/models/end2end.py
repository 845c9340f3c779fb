"""End-to-end serving function: preprocessing + forward + decode + NMS
(port of yolov6_tpu/models/end2end.py:21-65). Outputs follow the reference
End2End contract: (num_dets [b,1] int32, boxes [b,max_det,4],
scores [b,max_det], classes [b,max_det] int32)."""

from __future__ import annotations

import torch

from yolov6_tpu_torch.ops.nms import non_max_suppression
from yolov6_tpu_torch.utils.device import resolve_device


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
    dtype = torch.bfloat16 if half else torch.float32

    @torch.inference_mode()
    def serve(images):
        x = torch.as_tensor(images, device=device).permute(0, 3, 1, 2).to(dtype).contiguous()
        if with_preprocess:
            x = x.flip(1) / 255.0  # BGR -> RGB, normalize
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=half):
            head_out, _ = model(x)
        preds = model.decode(head_out)
        dets, valid = non_max_suppression(
            preds, conf_thres, iou_thres, max_det=max_det, multi_label=False
        )
        num_dets = valid.sum(1, keepdim=True, dtype=torch.int32)
        return num_dets, dets[..., :4], dets[..., 4], dets[..., 5].to(torch.int32)

    return serve
