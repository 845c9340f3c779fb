"""Carry weights from the JAX package's models, deploy or train, to the port.

An own copy of the naming in yolov6_tpu/utils/torch_import.py:176-218: the
flax module path joined with dots is the torch module path, because both
packages use the upstream attribute names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# (collection, JAX leaf) -> torch suffix; kernels are handled apart
_LEAF_MAP = {
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",  # BatchNorm gamma
    ("params", "alpha"): "alpha",  # BottleRep's residual scale
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX variables -> the port's ``state_dict``, for
    ``load_state_dict(..., strict=True)``: deploy variables
    (``{"params": ...}``) for the deploy graph, or train variables
    (``{"params", "batch_stats"}``) for the train graph.

    Conv kernels go HWIO -> OIHW. A ``Transpose`` block, the only module of
    these graphs with a (2, 2, in, out) kernel, maps both its kernel, as
    (in, out, 2, 2), and its bias under ``<module>.upsample_transpose``. BN
    leaves map ``scale``/``bias``/``mean``/``var`` to ``weight``/``bias``/
    ``running_mean``/``running_var``, and each BN gets torch's
    ``num_batches_tracked``, 0. A BottleRep's ``alpha`` keeps its name."""
    flat = _flatten({k: dict(v) for k, v in variables.items() if k in ("params", "batch_stats")})
    transposes = {
        path[1:-1]
        for path, v in flat.items()
        if path[:1] == ("params",) and path[-1] == "kernel" and np.ndim(v) == 4
        and np.shape(v)[:2] == (2, 2)
    }
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        col, mods, leaf = path[0], path[1:-1], path[-1]
        v = np.asarray(value, np.float32)
        if (col, leaf) == ("params", "kernel"):
            suffix = "weight"
            if mods in transposes:
                v = v.transpose(2, 3, 0, 1)
            elif v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
        elif (col, leaf) in _LEAF_MAP:
            suffix = _LEAF_MAP[(col, leaf)]
        else:
            raise KeyError(f"no mapping for JAX leaf {'/'.join(path)}")
        names = list(mods) + (["upsample_transpose"] if mods in transposes else []) + [suffix]
        out[".".join(names)] = torch.from_numpy(np.array(v))  # a writable copy
        if leaf == "scale":
            out[".".join(list(mods) + ["num_batches_tracked"])] = torch.tensor(0)
    return out
