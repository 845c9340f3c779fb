"""Carry weights from the JAX package's deploy models to the port.

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


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX deploy variables (``{"params": nested dict of arrays}``) -> the
    port's ``state_dict``, for ``load_state_dict(..., strict=True)``.

    Conv kernels go HWIO -> OIHW. A ``Transpose`` block, the only module of
    the deploy graphs with a (2, 2, in, out) kernel, maps both its kernel, as
    (in, out, 2, 2), and its bias under ``<module>.upsample_transpose``."""
    params = _flatten({k: dict(v) for k, v in variables.items() if k == "params"})
    transposes = {
        path[1:-1]
        for path, v in params.items()
        if path[-1] == "kernel" and np.ndim(v) == 4 and np.shape(v)[:2] == (2, 2)
    }
    out: Dict[str, torch.Tensor] = {}
    for path, value in params.items():
        mods, leaf = path[1:-1], path[-1]
        v = np.asarray(value, np.float32)
        if leaf == "kernel":
            suffix = "weight"
            if mods in transposes:
                v = v.transpose(2, 3, 0, 1)
            elif v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
        elif leaf == "bias":
            suffix = "bias"
        else:
            raise KeyError(f"no deploy mapping for JAX leaf {'/'.join(path)}")
        names = list(mods) + (["upsample_transpose"] if mods in transposes else []) + [suffix]
        out[".".join(names)] = torch.from_numpy(np.ascontiguousarray(v))
    return out
