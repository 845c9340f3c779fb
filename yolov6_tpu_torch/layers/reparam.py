"""Structural re-parameterization: fold a train state dict into the deploy one.

The port's own copy of yolov6_tpu/layers/reparam.py:20-90 (``fuse_conv_bn``,
``pad_1x1_to_3x3``, ``identity_kernel_3x3``, ``repvgg_fold``), in the torch
layout OIHW (output channels first) where the JAX copy is HWIO. Like it, the
folds run in float32 numpy, so the two agree to rounding.

``fold_to_deploy`` is the port's counterpart of the JAX
``native_variables_to_torch_state`` + ``import_checkpoint(..., deploy=True)``
(utils/torch_import.py:83-153, 191-297): the train graph's state dict in, the
state dict of the deploy graph that ``build_model(..., deploy=True)`` builds
out.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

BN_EPS = 1e-3  # layers/common.py::batch_norm


def fuse_conv_bn(kernel, bias, gamma, beta, mean, var, eps):
    """Fold a BatchNorm into the conv before it:
    ``y = gamma * (conv(x) + bias - mean) / sqrt(var + eps) + beta``."""
    kernel = np.asarray(kernel, np.float32)
    std = np.sqrt(np.asarray(var, np.float32) + np.float32(eps))
    t = np.asarray(gamma, np.float32) / std
    b = np.zeros(kernel.shape[0], np.float32) if bias is None else np.asarray(bias, np.float32)
    fused_kernel = kernel * t.reshape((-1,) + (1,) * (kernel.ndim - 1))
    fused_bias = np.asarray(beta, np.float32) + (b - np.asarray(mean, np.float32)) * t
    return fused_kernel, fused_bias


def pad_1x1_to_3x3(kernel_1x1):
    """Zero-pad an (O, I, 1, 1) kernel to (O, I, 3, 3), the centre tap."""
    k = np.asarray(kernel_1x1, np.float32)
    out = np.zeros(k.shape[:2] + (3, 3), np.float32)
    out[:, :, 1, 1] = k[:, :, 0, 0]
    return out


def identity_kernel_3x3(channels: int) -> np.ndarray:
    """(O, I, 3, 3) kernel that computes the identity (O = I = channels)."""
    k = np.zeros((channels, channels, 3, 3), np.float32)
    k[np.arange(channels), np.arange(channels), 1, 1] = 1.0
    return k


def repvgg_fold(dense_kernel, dense_bn, onexone_kernel, onexone_bn, identity_bn, channels):
    """RepVGGBlock fold: the 3x3 and 1x1 conv+BN branches and the identity BN
    (``None`` when the block has none), each given as ``{gamma, beta, mean,
    var, eps}``, summed into one (3x3 kernel, bias)."""
    k3, b3 = fuse_conv_bn(dense_kernel, None, **dense_bn)
    k1, b1 = fuse_conv_bn(onexone_kernel, None, **onexone_bn)
    kernel = k3 + pad_1x1_to_3x3(k1)
    bias = b3 + b1
    if identity_bn is not None:
        kid, bid = fuse_conv_bn(identity_kernel_3x3(channels), None, **identity_bn)
        kernel = kernel + kid
        bias = bias + bid
    return kernel, bias


# the heads' branches that only the training recipes' losses read
TRAIN_ONLY_BRANCHES = ("detect.cls_preds_ab.", "detect.reg_preds_ab.", "detect.reg_preds_dist.")


def fold_to_deploy(train_state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The train graph's state dict -> the deploy graph's, as CPU float32
    tensors for ``load_state_dict(..., strict=True)``:

    - ``X.rbr_dense`` + ``X.rbr_1x1`` + ``X.rbr_identity`` -> ``X.rbr_reparam``;
    - ``X.conv`` + ``X.bn`` -> ``X.conv`` with a bias;
    - the train-only branches of the fuse-AB and distill-NS heads
      (``TRAIN_ONLY_BRANCHES``) are dropped: the deploy graph is ``Detect``'s;
    - every other tensor (Transpose, the prediction convs) passes through.

    BN ``num_batches_tracked`` counters are dropped with their BNs."""
    sd = {k: v.detach().to("cpu", torch.float32).numpy().copy()
          for k, v in train_state_dict.items()
          if not k.endswith(".num_batches_tracked") and not k.startswith(TRAIN_ONLY_BRANCHES)}
    used = set()

    def take(key):
        used.add(key)
        return sd[key]

    def bn(prefix):
        return dict(gamma=take(f"{prefix}.weight"), beta=take(f"{prefix}.bias"),
                    mean=take(f"{prefix}.running_mean"), var=take(f"{prefix}.running_var"),
                    eps=BN_EPS)

    out = {}
    dense_suffix = ".rbr_dense.conv.weight"
    for key in [k for k in sd if k.endswith(dense_suffix)]:
        prefix = key[: -len(dense_suffix)]
        dense = take(key)
        identity = f"{prefix}.rbr_identity"
        kernel, bias = repvgg_fold(
            dense, bn(f"{prefix}.rbr_dense.bn"), take(f"{prefix}.rbr_1x1.conv.weight"),
            bn(f"{prefix}.rbr_1x1.bn"),
            bn(identity) if f"{identity}.weight" in sd else None, dense.shape[0])
        out[f"{prefix}.rbr_reparam.weight"], out[f"{prefix}.rbr_reparam.bias"] = kernel, bias
    for key in [k for k in sd if k.endswith(".conv.weight") and k not in used]:
        prefix = key[: -len(".conv.weight")]
        if f"{prefix}.bn.weight" in sd:  # a train-form conv has no bias of its own
            out[f"{prefix}.conv.weight"], out[f"{prefix}.conv.bias"] = fuse_conv_bn(
                take(key), None, **bn(f"{prefix}.bn"))
    out.update((k, v) for k, v in sd.items() if k not in used)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
