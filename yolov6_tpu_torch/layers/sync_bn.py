"""BatchNorm over every rank's batch (the port's counterpart of the JAX
``TorchBatchNorm`` under a mesh, yolov6_tpu/layers/common.py:112-155, whose
train-mode mean runs over the sharded batch axis).

In train mode the statistics are those of the global batch and their
gradient crosses the ranks: two passes of differentiable sums over the
ranks, the channel sums and counts for the mean, then the squared
deviations from that mean for the biased variance, so no E[x²] − E[x]²
cancellation. ``running_var`` takes the unbiased variance over the global
count, with torch's momentum. In eval mode the layer is
``nn.BatchNorm2d`` itself, and a world of one keeps plain BatchNorm
(``convert_sync_batchnorm``). It runs on either device: the
collectives are ``parallel/dist.py``'s.
"""

from __future__ import annotations

import torch
from torch import nn

from yolov6_tpu_torch.parallel.dist import all_reduce_sum, world_size


class SyncBatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and state-dict keys) whose
    train-mode statistics are taken over every rank's batch."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        c = x.shape[1]
        dims = (0, 2, 3)
        count = xf.new_full((1,), float(x.numel() // c))
        sums = all_reduce_sum(torch.cat([xf.sum(dims), count]))
        n = sums[c:]
        mean = sums[:c] / n
        centred = xf - mean[None, :, None, None]
        var = all_reduce_sum(centred.square().sum(dims)) / n
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        with torch.no_grad():
            m = self.momentum
            unbiased = var * (n / (n - 1).clamp(min=1.0))
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(unbiased, alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def convert_sync_batchnorm(model: nn.Module) -> nn.Module:
    """Turn every ``nn.BatchNorm2d`` of ``model`` into a ``SyncBatchNorm`` in
    place (the class changes; the module, its tensors and their names stay)
    when the world holds more than one rank; with one process the model
    keeps plain BatchNorm. Returns ``model``. ``make_train_step`` calls it
    before it flattens the model's tensors."""
    if world_size() == 1:
        return model
    for mod in model.modules():
        if type(mod) is nn.BatchNorm2d:
            if not (mod.affine and mod.track_running_stats and mod.momentum is not None):
                raise ValueError(f"{mod}: the synchronised BatchNorm takes the port's "
                                 "affine BN with running statistics and a momentum")
            mod.__class__ = SyncBatchNorm
    return model
