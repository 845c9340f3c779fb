"""Load a saved state dict into the deploy graph.

The JAX package reads its msgpack checkpoints (yolov6_tpu/utils/checkpoint.py);
the port reads what ``torch.save`` wrote: a state dict, bare or under
``'ema'`` or ``'model'`` (the EMA first, as the reference's eval takes it).
A train-form dict (RepVGG's three branches, conv+BN) is folded into the
deploy form by ``layers/reparam.py::fold_to_deploy``. The JAX package's
weights reach the port through ``utils/weights.py::state_dict_from_jax``.
"""

from __future__ import annotations

import os

import torch

from yolov6_tpu_torch.layers.reparam import fold_to_deploy
from yolov6_tpu_torch.models.yolo import Model, build_model

_TRAIN_FORM_MARKERS = (".rbr_dense.", ".bn.")


def load_state_dict_file(path: str, cfg, device="cuda") -> Model:
    """The deploy graph of ``cfg`` on ``device``, its weights loaded with
    ``strict=True`` from the ``torch.save``d file at ``path`` (read with
    ``weights_only=True``). The class count comes from the head's class
    prediction weights."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"weights file {path} not found (the port downloads nothing)")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("ema", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict) or not all(torch.is_tensor(v) for v in obj.values()):
        raise ValueError(f"{path}: not a state dict of tensors (bare, or under 'ema' or 'model')")
    if any(m in k for k in obj for m in _TRAIN_FORM_MARKERS):
        obj = fold_to_deploy(obj)
    cls_keys = sorted(k for k in obj if k.startswith("detect.cls_preds.") and k.endswith(".weight"))
    if not cls_keys:
        raise ValueError(f"{path}: no detect.cls_preds.*.weight, not a detector's state dict")
    model = build_model(cfg, num_classes=int(obj[cls_keys[0]].shape[0]), deploy=True,
                        device=device)
    model.load_state_dict(obj, strict=True)
    return model
