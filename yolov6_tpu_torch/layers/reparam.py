"""Structural re-parameterization: fold a train state dict into the deploy one.

The port's own copy of yolov6_tpu/layers/reparam.py:20-116 (``fuse_conv_bn``,
which also serves as the JAX ``fuse_extra_bn``, ``pad_1x1_to_3x3``,
``identity_kernel_3x3``, ``avg_kernel_3x3``, ``repvgg_fold``,
``qarepvgg_fold``, ``linearadd_fold``), in the torch layout OIHW (output channels first) where
the JAX copy is HWIO. Like it, the folds run in float32 numpy, so the two
agree to rounding.

``fold_to_deploy`` is the port's counterpart of the JAX
``native_variables_to_torch_state`` + ``import_checkpoint(..., deploy=True)``
(utils/torch_import.py:83-153, 191-297): the train graph's state dict in, the
state dict of the deploy graph that ``build_model(..., deploy=True)`` builds
out.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

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


def avg_kernel_3x3(channels: int) -> np.ndarray:
    """(O, I, 3, 3) kernel that computes a 3x3 average pool (zeros counted at
    the border) of each channel (O = I = channels)."""
    k = np.zeros((channels, channels, 3, 3), np.float32)
    k[np.arange(channels), np.arange(channels)] = 1.0 / 9
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


def qarepvgg_fold(dense_kernel, dense_bn, onexone_kernel, post_bn, has_identity: bool,
                  has_avg: bool, channels: int):
    """QARepVGGBlock / V2 fold: the 3x3 conv+BN branch, the bare 1x1 kernel,
    the identity and the average pool (where the block has them) summed into
    one 3x3 kernel, then the post-sum BN folded into it and the dense
    branch's bias (``fuse_conv_bn`` with a bias: the JAX ``fuse_extra_bn``'s
    ``beta - (mean - bias) * t`` is the same float32 value)."""
    kernel, bias = fuse_conv_bn(dense_kernel, None, **dense_bn)
    kernel = kernel + pad_1x1_to_3x3(onexone_kernel)
    if has_avg:
        kernel = kernel + avg_kernel_3x3(channels)
    if has_identity:
        kernel = kernel + identity_kernel_3x3(channels)
    return fuse_conv_bn(kernel, bias, **post_bn)


def linearadd_fold(conv_kernel, scale_conv, onexone_kernel, scale_1x1, scale_identity,
                   channels: int):
    """LinearAddBlock (CSLA) fold, which RepOpt's re-init uses
    (solver/repoptimizer.py): ``3x3 * s_conv + pad(1x1 * s_1x1) + id *
    s_id``, each scale per output channel; ``scale_identity`` is ``None``
    for a block without the identity branch."""
    out_scale = (-1, 1, 1, 1)
    k = np.asarray(conv_kernel, np.float32) * np.asarray(scale_conv, np.float32).reshape(out_scale)
    k = k + pad_1x1_to_3x3(np.asarray(onexone_kernel, np.float32)
                           * np.asarray(scale_1x1, np.float32).reshape(out_scale))
    if scale_identity is not None:
        k = k + identity_kernel_3x3(channels) * np.asarray(scale_identity,
                                                          np.float32).reshape(out_scale)
    return k


# DPBlock's convs and the BNs after them (layers/common.py::DPBlock)
DP_BN_SIBLING = {"conv_dw_1": "bn_1", "conv_pw_1": "bn_2"}
# the heads' branches that only the training recipes' losses read
TRAIN_ONLY_BRANCHES = ("detect.cls_preds_ab.", "detect.reg_preds_ab.", "detect.reg_preds_dist.")


def fold_to_deploy(train_state_dict: Mapping[str, torch.Tensor],
                   graph: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """The train graph's state dict -> the deploy graph's, as CPU float32
    tensors for ``load_state_dict(..., strict=True)``:

    - ``X.rbr_dense`` + ``X.rbr_1x1`` + ``X.rbr_identity`` -> ``X.rbr_reparam``
      (RepVGG);
    - ``X.rbr_dense`` + ``X.rbr_1x1`` (a bare conv) + ``X.bn`` ->
      ``X.rbr_reparam`` (QARepVGG), with the identity and, in V2, the
      average branch where the block has them: when in == out and its stride
      is 1. A state dict cannot tell the stride, nor V1 from V2, so a
      QARepVGG block with in == out reads both from ``graph``'s module at
      ``X`` (a train or deploy graph of the same config); without ``graph``
      such a block raises ``ValueError``;
    - ``X.conv`` (+ its bias, if any) + ``X.bn`` -> ``X.conv`` with a bias;
    - DPBlock's ``X.conv_dw_1`` + ``X.bn_1`` and ``X.conv_pw_1`` + ``X.bn_2``
      (convs with a bias of their own) -> the convs with the BN folded in;
    - the train-only branches of the fuse-AB and distill-NS heads
      (``TRAIN_ONLY_BRANCHES``) are dropped: the deploy graph is ``Detect``'s;
    - RepOpt's hyper-search blocks (``LinearAddBlock``: ``X.conv``,
      ``X.scale_conv``, ``X.conv_1x1``, ``X.scale_1x1``,
      ``X.scale_identity``, ``X.bn``) pass through whole, BN counter
      included: the block has no deploy form, and its 3x3 conv sits before
      the scale and the sum, not before the BN. Each is found by its
      ``scale_conv.weight``; with ``graph`` the module there must be a
      ``LinearAddBlock``;
    - every other tensor (Transpose, SEBlock's convs, the prediction convs)
      passes through.

    BN ``num_batches_tracked`` counters are dropped with their BNs."""
    linear_add = {k[: -len(".scale_conv.weight")] if k != "scale_conv.weight" else ""
                  for k in train_state_dict if k.endswith("scale_conv.weight")}
    if graph is not None:
        from yolov6_tpu_torch.layers.common import LinearAddBlock

        for prefix in linear_add:
            if not isinstance(graph.get_submodule(prefix), LinearAddBlock):
                raise ValueError(f"{prefix or 'the graph'}: a scale_conv in the state dict, "
                                 "but the graph's module there is no LinearAddBlock")

    def in_linear_add(key):
        return any(key.startswith(f"{p}.") if p else True for p in linear_add)

    passed = {k: v.detach().to("cpu").clone() for k, v in train_state_dict.items()
              if in_linear_add(k)}
    sd = {k: v.detach().to("cpu", torch.float32).numpy().copy()
          for k, v in train_state_dict.items()
          if not k.endswith(".num_batches_tracked") and not k.startswith(TRAIN_ONLY_BRANCHES)
          and k not in passed}
    used = set()

    def take(key):
        used.add(key)
        return sd[key]

    def at(prefix, name):  # the key of ``name`` in the module at ``prefix``
        return f"{prefix}.{name}" if prefix else name

    def prefixes(name):  # the modules that hold ``name``, the graph's own included
        return [k[: -len(name) - 1] if k != name else "" for k in list(sd)
                if k == name or k.endswith(f".{name}")]

    def bn(prefix):
        return dict(gamma=take(at(prefix, "weight")), beta=take(at(prefix, "bias")),
                    mean=take(at(prefix, "running_mean")), var=take(at(prefix, "running_var")),
                    eps=BN_EPS)

    def conv_bn(prefix, conv, norm):  # a train-form ConvModule's conv has no bias; DPBlock's has
        w, b = at(prefix, f"{conv}.weight"), at(prefix, f"{conv}.bias")
        out[w], out[b] = fuse_conv_bn(take(w), take(b) if b in sd else None,
                                      **bn(at(prefix, norm)))

    out = {}
    for prefix in prefixes("rbr_dense.conv.weight"):
        dense = take(at(prefix, "rbr_dense.conv.weight"))
        if at(prefix, "rbr_1x1.weight") in sd:  # QARepVGG
            channels, in_channels = dense.shape[:2]
            has_identity = has_avg = False
            if channels == in_channels:
                if graph is None:
                    raise ValueError(f"{prefix or 'the graph'}: a QARepVGG block with in == out; "
                                     "its stride and version come from the graph: pass graph=")
                block = graph.get_submodule(prefix)
                has_identity, has_avg = block.has_identity, block.has_avg
            kernel, bias = qarepvgg_fold(
                dense, bn(at(prefix, "rbr_dense.bn")), take(at(prefix, "rbr_1x1.weight")),
                bn(at(prefix, "bn")), has_identity, has_avg, channels)
        else:
            identity = at(prefix, "rbr_identity")
            kernel, bias = repvgg_fold(
                dense, bn(at(prefix, "rbr_dense.bn")), take(at(prefix, "rbr_1x1.conv.weight")),
                bn(at(prefix, "rbr_1x1.bn")),
                bn(identity) if f"{identity}.weight" in sd else None, dense.shape[0])
        out[at(prefix, "rbr_reparam.weight")], out[at(prefix, "rbr_reparam.bias")] = kernel, bias
    for conv, norm in (("conv", "bn"), *DP_BN_SIBLING.items()):
        for prefix in prefixes(f"{conv}.weight"):
            if at(prefix, f"{conv}.weight") not in used and at(prefix, f"{norm}.weight") in sd:
                conv_bn(prefix, conv, norm)
    out.update((k, v) for k, v in sd.items() if k not in used)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
    out.update((k, v if k.endswith(".num_batches_tracked") else v.float())
               for k, v in passed.items())
    return out
