"""Checkpoints: the trainer's save, strip and resume, and loading a saved
state dict into the deploy graph (port of yolov6_tpu/utils/checkpoint.py:28-62).

The JAX package writes msgpack; the port writes with ``torch.save`` a dict
of ``train_state`` (``TrainStep.state_dict()``), ``model`` and ``ema`` (the
train-form state dicts), ``epoch`` and ``results`` ((AP50, AP) of the last
eval), every tensor on the CPU. ``strip_optimizer`` leaves ``model`` (the
EMA) and ``epoch``. ``load_state_dict_file`` reads a state dict, bare or
under ``'ema'`` or ``'model'`` (the EMA first, as the reference's eval takes
it), and folds a train-form dict (RepVGG's and QARepVGG's branches, conv+BN)
into the deploy form by ``layers/reparam.py::fold_to_deploy``. The JAX package's
weights reach the port through ``utils/weights.py::state_dict_from_jax``.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
from typing import Any, Dict

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
    cls_keys = sorted(k for k in obj if k.startswith("detect.cls_preds.") and k.endswith(".weight"))
    if not cls_keys:
        raise ValueError(f"{path}: no detect.cls_preds.*.weight, not a detector's state dict")
    model = build_model(cfg, num_classes=int(obj[cls_keys[0]].shape[0]), deploy=True,
                        device=device)
    if any(m in k for k in obj for m in _TRAIN_FORM_MARKERS):
        obj = fold_to_deploy(obj, model)
    model.load_state_dict(obj, strict=True)
    return model


def save_checkpoint(ckpt: Dict[str, Any], is_best: bool, save_dir: str,
                    model_name: str = "last_ckpt") -> str:
    """``torch.save`` ``ckpt`` to ``<save_dir>/<model_name>.pt`` (written to a
    temporary name, then renamed), and copy it to ``best_ckpt.pt`` when
    ``is_best`` (reference: checkpoint.py:35-43). Returns the path."""
    os.makedirs(save_dir, exist_ok=True)
    path = osp.join(save_dir, f"{model_name}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    if is_best:
        shutil.copyfile(path, osp.join(save_dir, "best_ckpt.pt"))
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint written by ``save_checkpoint``, its tensors on the CPU
    (read with ``weights_only=True``)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path} not found")
    return torch.load(path, map_location="cpu", weights_only=True)


def strip_optimizer(ckpt_dir: str, epoch: int) -> None:
    """Keep only the EMA weights, as ``model``, and the epoch in the final
    ``best_ckpt.pt`` and ``last_ckpt.pt`` (reference: checkpoint.py:46-61)."""
    for name in ("best_ckpt", "last_ckpt"):
        path = osp.join(ckpt_dir, f"{name}.pt")
        if not osp.exists(path):
            continue
        ckpt = load_checkpoint(path)
        out = {"model": ckpt.get("ema") or ckpt.get("model"), "epoch": ckpt.get("epoch", epoch)}
        save_checkpoint(out, False, ckpt_dir, name)
