"""The port's NMS against the JAX package.

The greedy keep's plain torch version (the CUDA kernel's reference) must
emit the same index sequence as the Pallas kernel run in interpret mode.
The port's ``non_max_suppression`` must give the same valid masks, classes,
boxes and scores as JAX ``non_max_suppression(..., exact_topk=True)`` on the
same predictions: both do the same fp32 arithmetic, so all are compared
exactly.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp

from yolov6_tpu.ops.nms import non_max_suppression as jax_nms
from yolov6_tpu.ops.pallas.nms_kernel import pallas_greedy_nms

from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms, greedy_nms_plain
from yolov6_tpu_torch.ops.nms import non_max_suppression

from torch_port_utils import clustered_candidates


@pytest.mark.parametrize("zero_area", [0, 5], ids=["clustered", "zero_area_boxes"])
def test_plain_keep_matches_pallas_interpret(zero_area):
    boxes, scores = clustered_candidates(0, B=2, K=384, zero_area=zero_area)
    max_det, iou = 80, 0.5
    rows, valid_p = pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), max_det, iou,
                                      interpret=True)
    rows, valid_p = np.asarray(rows), np.asarray(valid_p)
    idx, valid = greedy_nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores), max_det, iou)
    np.testing.assert_array_equal(valid.numpy(), valid_p)
    assert valid_p.sum() > 40  # many steps, not a short chain
    np.testing.assert_array_equal(idx.numpy(), np.where(valid_p, rows[..., 5], 0).astype(np.int32))
    if zero_area:  # a zero-area box never suppresses itself: it is emitted again
        kept = idx.numpy()[valid.numpy()]
        assert len(kept) > len(set(kept.tolist()))


def test_greedy_nms_wrapper_on_cpu_uses_plain_version():
    boxes, scores = clustered_candidates(1, B=3, K=200)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = greedy_nms.launches
    got = greedy_nms(b, s, 50, 0.45)
    want = greedy_nms_plain(b, s, 50, 0.45)
    assert greedy_nms.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


@pytest.mark.parametrize("bad", ["dtype", "shape", "empty"])
def test_greedy_nms_wrapper_rejects_bad_input(bad):
    boxes, scores = (torch.from_numpy(a) for a in clustered_candidates(2, B=2, K=64))
    if bad == "dtype":
        boxes = boxes.double()
    elif bad == "shape":
        scores = scores[:, :10]
    else:
        boxes, scores = boxes[:, :0], scores[:, :0]
    with pytest.raises(ValueError):
        greedy_nms(boxes, scores, 10, 0.5)


def _preds(seed, B=2, A=600, nc=80, img=320):
    """[B, A, 5+nc] decoded predictions: xywh boxes, obj in [0.5, 1), sparse
    class scores."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, img, (B, A, 2))
    wh = rng.uniform(10, 80, (B, A, 2))
    obj = rng.uniform(0.5, 1.0, (B, A, 1))
    cls = rng.uniform(0, 1, (B, A, nc)) ** 4
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


# (id, kwargs shared by both sides, JAX-only kwargs)
NMS_CASES = [
    ("serve_single_label", dict(conf_thres=0.25, iou_thres=0.45, max_det=100), {}),
    ("single_label_loop", dict(conf_thres=0.25, iou_thres=0.45, max_det=100), dict(method="loop")),
    ("eval_multi_label_grouped", dict(conf_thres=0.03, iou_thres=0.65, max_det=300,
                                      max_nms=2048, multi_label=True), {}),
    ("multi_label_topk", dict(conf_thres=0.03, iou_thres=0.65, max_det=300, max_nms=2048,
                              multi_label=True, row_select="topk"), {}),
    ("multi_label_all_classes", dict(conf_thres=0.2, iou_thres=0.65, max_det=300,
                                     max_nms=4096, multi_label=True, anchor_topc=0), {}),
    ("agnostic", dict(conf_thres=0.1, iou_thres=0.45, max_det=100, agnostic=True), {}),
    ("class_mask", dict(conf_thres=0.03, iou_thres=0.65, max_det=300, max_nms=2048,
                        multi_label=True), {}),
]


@pytest.mark.parametrize("case", NMS_CASES, ids=[c[0] for c in NMS_CASES])
def test_nms_matches_jax(case):
    name, kw, jax_kw = case
    pred = _preds(seed=len(name))
    mask = None
    if name == "class_mask":
        mask = (np.arange(80) % 3 == 0).astype(np.float32)
    dets_j, valid_j = jax_nms(jnp.asarray(pred), exact_topk=True,
                              class_mask=None if mask is None else jnp.asarray(mask),
                              **kw, **jax_kw)
    dets_t, valid_t = non_max_suppression(
        torch.from_numpy(pred), class_mask=None if mask is None else torch.from_numpy(mask), **kw
    )
    valid_j, dets_j = np.asarray(valid_j), np.asarray(dets_j)
    assert valid_j.sum() > 20
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    np.testing.assert_array_equal(dets_t[..., 5].numpy(), dets_j[..., 5])
    np.testing.assert_array_equal(dets_t.numpy(), dets_j)
    if mask is not None:
        assert np.all(mask[dets_t[..., 5].numpy()[valid_t.numpy()].astype(int)] == 1)


@pytest.mark.parametrize("method", ["tiled", "perclass"])
def test_unported_keep_methods_raise(method):
    with pytest.raises(NotImplementedError):
        non_max_suppression(torch.from_numpy(_preds(0, A=20)), method=method)
