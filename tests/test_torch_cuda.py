"""The port's CUDA kernels on the card. Every test here needs an NVIDIA GPU
and skips without one; none imports JAX, so they run where JAX is absent:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from yolov6_tpu_torch.ops.cuda.nms_kernel import MAX_K, TILE, greedy_nms, greedy_nms_plain

from torch_port_utils import clustered_candidates


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _candidates(device, seed, B, K, **kw):
    return tuple(torch.from_numpy(a).to(device) for a in clustered_candidates(seed, B, K, **kw))


def _sorted(boxes, scores):
    """As the selection stage hands candidates over: descending, ties in index order."""
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous(), scores


@pytest.mark.cuda
@pytest.mark.parametrize("emit_once", [True, False], ids=["emit_once", "pallas_rule"])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("B,K,max_det,iou,zero_area", [
    (8, 8400, 100, 0.45, 0),
    (4, 8192, 300, 0.65, 0),
    (2, 1000, 60, 0.5, 7),
    (3, 5, 20, 0.5, 0),
    (2, 30000, 300, 0.65, 0),
])
def test_kernel_matches_plain(cuda_device, B, K, max_det, iou, zero_area, sort, emit_once):
    """Equal idx/valid to the plain version under both rules, on both paths:
    the tile walk (path 1) on sorted candidates, the argmax loop (path 0) on
    unsorted ones."""
    boxes, scores = _candidates(cuda_device, 3, B, K, n_clusters=40, n_cls=20,
                                zero_area=zero_area)
    if sort:
        boxes, scores = _sorted(boxes, scores)
    before = greedy_nms.launches
    idx, valid = greedy_nms(boxes, scores, max_det, iou, emit_once=emit_once)
    want_idx, want_valid = greedy_nms_plain(boxes, scores, max_det, iou, emit_once=emit_once)
    torch.cuda.synchronize()
    assert greedy_nms.launches == before + 1
    assert torch.equal(valid, want_valid)
    assert torch.equal(idx, want_idx)
    assert (greedy_nms.last_path == int(sort)).all()
    tiles = greedy_nms.last_tiles
    if sort:
        assert (tiles >= 1).all() and (tiles <= -(-K // TILE)).all()
    else:
        assert (tiles == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_kernel_rules_on_degenerate_boxes(cuda_device, sort):
    """Zero-area and inverted boxes among the best scores: the two rules
    differ, and the kernel equals the plain version under each."""
    boxes, scores = _candidates(cuda_device, 8, 4, 2000, n_clusters=30, n_cls=5)
    top = torch.argsort(scores, dim=1, descending=True)[:, :64]
    for b in range(4):
        z, inv = top[b, 5::8], top[b, 9::8]
        boxes[b, z, 2] = boxes[b, z, 0]
        boxes[b, inv] = boxes[b, inv][:, [2, 3, 0, 1]]
    if sort:
        boxes, scores = _sorted(boxes, scores)
    outs = {}
    for emit_once in (True, False):
        got = greedy_nms(boxes, scores, 150, 0.5, emit_once=emit_once)
        want = greedy_nms_plain(boxes, scores, 150, 0.5, emit_once=emit_once)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert (greedy_nms.last_path == int(sort)).all()
        outs[emit_once] = got
    assert not torch.equal(outs[True][0], outs[False][0])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["non_contiguous", "too_many_candidates", "too_many_rows",
                                 "misaligned"])
def test_kernel_wrapper_rejects(cuda_device, bad):
    if bad == "non_contiguous":
        boxes, scores = _candidates(cuda_device, 4, 2, 64)
        boxes = boxes.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "misaligned":
        boxes = torch.zeros(2 * 64 * 4 + 1, device=cuda_device)[1:].view(2, 64, 4)
        scores = torch.zeros((2, 64), device=cuda_device)
    else:  # too many rows: the kept buffer, 20 bytes a row, outgrows shared memory
        K = MAX_K + 1 if bad == "too_many_candidates" else 12000
        boxes = torch.zeros((1, K, 4), device=cuda_device)
        scores = torch.zeros((1, K), device=cuda_device)
    max_det = 12000 if bad == "too_many_rows" else 10
    with pytest.raises(ValueError):
        greedy_nms(boxes, scores, max_det, 0.5)
