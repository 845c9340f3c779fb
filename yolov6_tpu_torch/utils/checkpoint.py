"""Checkpoints: the trainer's save, strip and resume, loading a saved state
dict into the deploy graph, and the fine-tune's partial load (port of
yolov6_tpu/utils/checkpoint.py:28-62, 126-143).

The JAX package writes msgpack; the port writes with ``torch.save`` a dict
of ``train_state`` (``TrainStep.state_dict()``), ``model`` and ``ema`` (the
train-form state dicts), ``epoch`` and ``results`` ((AP50, AP) of the last
eval), every tensor on the CPU. ``strip_optimizer`` leaves ``model`` (the
EMA) and ``epoch``. ``read_state_dict`` reads a model's state dict from
either format it knows, told apart by content (both end in ``.pt``): the
port's own file (a state dict, bare or under ``'ema'`` or ``'model'``, the
EMA first, as the reference's eval takes it; read with
``weights_only=True``) or an upstream YOLOv6 checkpoint
(``utils/upstream_ckpt.py``). A PTQ or QAT file (``quant/``) adds a
``quant`` entry of calibrated ranges beside the tensors of ``model``/``ema``
(and a PTQ file ``quant_bits``), as the JAX package's ``quant``
collection. ``load_state_dict_file`` folds a train-form
dict (RepVGG's and QARepVGG's branches, conv+BN) into the deploy form by
``layers/reparam.py::fold_to_deploy``. The JAX package's weights reach the
port through ``utils/weights.py::state_dict_from_jax``.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
from typing import Any, Dict, Mapping, Tuple

import torch
from torch import nn

from yolov6_tpu_torch.layers.reparam import TRAIN_ONLY_BRANCHES, fold_to_deploy
from yolov6_tpu_torch.models.yolo import Model, build_model
from yolov6_tpu_torch.utils.events import LOGGER
from yolov6_tpu_torch.utils.upstream_ckpt import checkpoint_format, read_upstream_checkpoint

_TRAIN_FORM_MARKERS = (".rbr_dense.", ".bn.")


def num_classes_of(state: Mapping[str, torch.Tensor], what: str = "the state dict") -> int:
    """The class count of a detector's state dict, from its head's class
    prediction weights."""
    cls_keys = sorted(k for k in state if k.startswith("detect.cls_preds.")
                      and k.endswith(".weight"))
    if not cls_keys:
        raise ValueError(f"{what}: no detect.cls_preds.*.weight, not a detector's state dict")
    return int(state[cls_keys[0]].shape[0])


def read_state_dict(path: str, with_quant: bool = False):
    """A model's state dict from the file at ``path``, either format (see
    the module doc), on the CPU. Its keys are checked by the caller, against
    the graph it loads them into. A PTQ or QAT file's ``quant`` entry (the
    calibrated ranges, ``{JAX path: fp32 scalar}``, beside the tensors) is
    split off: with ``with_quant`` the return is ``(state dict, ranges or
    None)``. Raises ``FileNotFoundError`` for a missing file, ``ValueError``
    for any other content."""
    if not osp.exists(path):
        raise FileNotFoundError(f"weights file {path} not found (the port downloads nothing)")
    quant = None
    if checkpoint_format(path) == "upstream":
        obj = read_upstream_checkpoint(path)
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("ema", "model"):
            if isinstance(obj, dict) and isinstance(obj.get(key), dict):
                obj = obj[key]
                break
        if isinstance(obj, dict) and isinstance(obj.get("quant"), dict):
            obj = dict(obj)
            quant = obj.pop("quant")
            if not all(torch.is_tensor(v) and v.dim() == 0 for v in quant.values()):
                raise ValueError(f"{path}: its 'quant' entry is not a dict of scalar ranges")
        if not isinstance(obj, dict) or not all(torch.is_tensor(v) for v in obj.values()):
            raise ValueError(f"{path}: not a state dict of tensors (bare, or under 'ema' or "
                             "'model')")
    return (obj, quant) if with_quant else obj


def load_state_dict_file(path: str, cfg, device="cuda") -> Model:
    """The deploy graph of ``cfg`` on ``device``, its weights loaded with
    ``strict=True`` from the file at ``path`` (``read_state_dict``: the
    port's own or an upstream checkpoint), folded when they are the train
    form. The class count comes from the head's class prediction weights.
    A PTQ or QAT file's ranges are attached as ``model.quant_ranges`` (else
    ``None``) and not enabled: the model serves in float, as the JAX eval
    CLI serves such a file (``quant/state.py::quant_mode`` enables them)."""
    obj, quant = read_state_dict(path, with_quant=True)
    model = build_model(cfg, num_classes=num_classes_of(obj, path), deploy=True, device=device)
    if any(m in k for k in obj for m in _TRAIN_FORM_MARKERS):
        obj = fold_to_deploy(obj, model)
    model.load_state_dict(obj, strict=True)
    model.quant_ranges = quant
    return model


def load_state_dict_partial(state: Mapping[str, torch.Tensor],
                            model: nn.Module) -> Tuple[int, int]:
    """The fine-tune's shape-matched partial load (JAX:
    checkpoint.py:126-143): copy into ``model`` every tensor of ``state``
    whose name and shape match one of its own, and keep its init for the
    rest (for example the class predictions under another class count).
    A key that ``model`` lacks, other than the recipes' train-only branches,
    raises ``ValueError``: the file is another model's (the JAX load skips
    it). Returns (matched, the model's tensors), which it logs as JAX does."""
    own = model.state_dict()
    extra = sorted(k for k in state if k not in own and not k.startswith(TRAIN_ONLY_BRANCHES))
    if extra:
        raise ValueError(f"{len(extra)} keys of the checkpoint are not in the train graph, "
                         f"e.g. {extra[:5]}: the file holds another model")
    matched = {k: v for k, v in state.items() if k in own and tuple(v.shape) == tuple(own[k].shape)}
    with torch.no_grad():
        for k, v in matched.items():
            own[k].copy_(v)
    LOGGER.info(f"partial load: matched {len(matched)}/{len(own)} tensors")
    return len(matched), len(own)


def cpu_copy(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """CPU copies of a mapping of tensors (a state dict, or quant ranges), for
    ``save_checkpoint``."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


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
