"""The port's CUDA kernels on the card. Every test here needs an NVIDIA GPU
and skips without one; none imports JAX, so they run where JAX is absent:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from yolov6_tpu_torch.ops.cuda.nms_kernel import MAX_K, greedy_nms, greedy_nms_plain

from torch_port_utils import clustered_candidates


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _candidates(device, seed, B, K, **kw):
    return tuple(torch.from_numpy(a).to(device) for a in clustered_candidates(seed, B, K, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,max_det,iou,zero_area", [
    (8, 8400, 100, 0.45, 0),
    (4, 8192, 300, 0.65, 0),
    (2, 1000, 60, 0.5, 7),
    (3, 5, 20, 0.5, 0),
])
def test_kernel_matches_plain(cuda_device, B, K, max_det, iou, zero_area):
    boxes, scores = _candidates(cuda_device, 3, B, K, n_clusters=40, n_cls=20,
                                zero_area=zero_area)
    before = greedy_nms.launches
    idx, valid = greedy_nms(boxes, scores, max_det, iou)
    want_idx, want_valid = greedy_nms_plain(boxes, scores, max_det, iou)
    torch.cuda.synchronize()
    assert greedy_nms.launches == before + 1
    assert torch.equal(valid, want_valid)
    assert torch.equal(idx, want_idx)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["non_contiguous", "too_many_candidates"])
def test_kernel_wrapper_rejects(cuda_device, bad):
    if bad == "non_contiguous":
        boxes, scores = _candidates(cuda_device, 4, 2, 64)
        boxes = boxes.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        boxes = torch.zeros((1, MAX_K + 1, 4), device=cuda_device)
        scores = torch.zeros((1, MAX_K + 1), device=cuda_device)
    with pytest.raises(ValueError):
        greedy_nms(boxes, scores, 10, 0.5)
