"""The synchronised BatchNorm (yolov6_tpu_torch/layers/sync_bn.py) against
``nn.BatchNorm2d`` on the whole batch, on the CPU.

Two gloo ranks (one spawn for the file) each take a slice of one seeded
batch (8 samples split 4 + 4, and 3 + 5) through a converted BN in train
mode and backpropagate their slice of one output gradient. Held to 1e-5
(absolute and relative) against one ``nn.BatchNorm2d`` on the whole batch:
the output, the input's gradient, the weight's and bias's gradients summed
over the ranks (the train step sums them), the running mean and variance
(unbiased over the global count) and the batch counter, equal on both
ranks; the eval-mode output is plain BN's. With no process group the
conversion leaves plain ``nn.BatchNorm2d``.
"""

import numpy as np
import pytest
import torch
from torch import nn

from yolov6_tpu_torch.layers.common import batch_norm
from yolov6_tpu_torch.layers.sync_bn import SyncBatchNorm, convert_sync_batchnorm

from torch_dist_utils import run_ranks

C, H, W = 6, 5, 7
SPLITS = {"even": (4, 4), "uneven": (3, 5)}
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (8, C, H, W)).astype(np.float32)  # offset: no cancellation hides
    g = rng.normal(0.0, 1.0, (8, C, H, W)).astype(np.float32)
    state = {"weight": rng.uniform(0.5, 1.5, C), "bias": rng.normal(0, 1, C),
             "running_mean": rng.normal(0, 1, C), "running_var": rng.uniform(0.5, 2, C)}
    state = {k: torch.tensor(v, dtype=torch.float32) for k, v in state.items()}
    state["num_batches_tracked"] = torch.tensor(3)
    return torch.from_numpy(x), torch.from_numpy(g), state


def _run(bn, x, g):
    x = x.clone().requires_grad_(True)
    y = bn(x)
    y.backward(g)
    return dict(y=y.detach(), x_grad=x.grad, weight_grad=bn.weight.grad,
                bias_grad=bn.bias.grad, running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone(),
                num_batches_tracked=bn.num_batches_tracked.clone())


def _rank(rank, world, x, g, state):
    out = {}
    for name, split in SPLITS.items():
        model = nn.Sequential(batch_norm(C))
        model.load_state_dict({f"0.{k}": v for k, v in state.items()})
        keys = list(model.state_dict())
        convert_sync_batchnorm(model)
        bn = model[0]
        assert type(bn) is SyncBatchNorm and list(model.state_dict()) == keys
        lo = sum(split[:rank])
        part = slice(lo, lo + split[rank])
        res = _run(bn.train(), x[part], g[part])
        bn.eval()
        with torch.no_grad():
            res["eval_y"] = bn(x[part])
        out[name] = res
    return out


@pytest.fixture(scope="module")
def ranks():
    x, g, state = _inputs()
    return run_ranks(_rank, 2, x, g, state)


@pytest.mark.parametrize("split", list(SPLITS))
def test_sync_bn_two_ranks_equal_batchnorm_on_the_whole_batch(ranks, split):
    x, g, state = _inputs()
    bn = batch_norm(C)
    bn.load_state_dict(state)
    want = _run(bn.train(), x, g)
    parts = [r[split] for r in ranks]
    torch.testing.assert_close(torch.cat([p["y"] for p in parts]), want["y"], **TOL)
    torch.testing.assert_close(torch.cat([p["x_grad"] for p in parts]), want["x_grad"], **TOL)
    for key in ("weight_grad", "bias_grad"):
        torch.testing.assert_close(parts[0][key] + parts[1][key], want[key], **TOL)
    for key in ("running_mean", "running_var", "num_batches_tracked"):
        for p in parts:
            torch.testing.assert_close(p[key], want[key], **TOL)
    bn.eval()
    with torch.no_grad():
        torch.testing.assert_close(torch.cat([p["eval_y"] for p in parts]), bn(x), **TOL)


def test_convert_without_a_group_keeps_plain_batchnorm():
    model = nn.Sequential(nn.Conv2d(3, C, 3, bias=False), batch_norm(C), nn.ReLU())
    assert convert_sync_batchnorm(model) is model
    assert type(model[1]) is nn.BatchNorm2d
