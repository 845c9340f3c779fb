"""The port's NMS against the JAX package.

The greedy keep's plain torch version (the CUDA kernel's reference) must
emit the same index sequence as the Pallas kernel run in interpret mode
under the Pallas rule, and as ``_tiled_keep`` + ``_emit_topk_kept`` under
the default rule. The port's ``non_max_suppression`` must give the same
valid masks, classes, boxes and scores as JAX
``non_max_suppression(..., exact_topk=True)`` on the same predictions, keep
method for keep method: both do the same fp32 arithmetic, so all are
compared exactly.
"""

from functools import partial

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.ops.nms import _emit_topk_kept, _tiled_keep
from yolov6_tpu.ops.nms import non_max_suppression as jax_nms
from yolov6_tpu.ops.pallas.nms_kernel import pallas_greedy_nms

from yolov6_tpu_torch.ops.cuda.nms_kernel import greedy_nms, greedy_nms_plain
from yolov6_tpu_torch.ops.nms import non_max_suppression

from torch_port_utils import clustered_candidates


def _sorted(boxes, scores):
    """Candidates in the order the selection stage hands them over: scores
    descending, ties in index order."""
    order = np.argsort(-scores, axis=1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], 1),
            np.take_along_axis(scores, order, 1))


# (zero-area boxes, sort the candidates); the unsorted cases keep their ids
PALLAS_CASES = [(0, False), (5, False), (0, True), (5, True)]


@pytest.mark.parametrize("zero_area,sort", PALLAS_CASES, ids=[
    "clustered", "zero_area_boxes", "clustered_sorted", "zero_area_boxes_sorted"])
def test_plain_keep_matches_pallas_interpret(zero_area, sort):
    boxes, scores = clustered_candidates(0, B=2, K=384, zero_area=zero_area)
    if sort:
        boxes, scores = _sorted(boxes, scores)
    max_det, iou = 80, 0.5
    rows, valid_p = pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), max_det, iou,
                                      interpret=True)
    rows, valid_p = np.asarray(rows), np.asarray(valid_p)
    idx, valid = greedy_nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores), max_det,
                                  iou, emit_once=False)
    np.testing.assert_array_equal(valid.numpy(), valid_p)
    assert valid_p.sum() > 40  # many steps, not a short chain
    np.testing.assert_array_equal(idx.numpy(), np.where(valid_p, rows[..., 5], 0).astype(np.int32))
    if zero_area:  # a zero-area box never suppresses itself: it is emitted again
        kept = idx.numpy()[valid.numpy()]
        assert len(kept) > len(set(kept.tolist()))


def _tiled_candidates(case):
    """Sorted candidates for the default rule's cases, and their max_det."""
    rng = np.random.default_rng(len(case))
    if case == "one_cluster":  # every box in one cluster of one class
        boxes, scores = clustered_candidates(5, B=2, K=300, n_clusters=1, n_cls=1)
        return (*_sorted(boxes, scores), 100)
    K = {"k_below_tile": 50, "k_ragged": 300}.get(case, 384)
    boxes, scores = clustered_candidates(6, B=2, K=K, n_clusters=12, n_cls=2)
    if case == "ties":  # scores on a coarse grid: runs of equal scores
        scores = np.where(scores > 0, np.ceil(scores * 8) / 8, 0).astype(np.float32)
    if case == "degenerate":  # zero-area and inverted boxes among the best
        top = np.argsort(-scores, axis=1)[:, :40]
        for b in range(2):
            z, inv = top[b, 0:40:4], top[b, 2:40:4]
            boxes[b, z, 2] = boxes[b, z, 0]
            boxes[b, inv] = boxes[b, inv][:, [2, 3, 0, 1]]
    if case == "max_det_above_n_pos":  # few candidates above conf
        scores = np.where(rng.uniform(0, 1, scores.shape) < 0.1, scores, 0).astype(np.float32)
        return (*_sorted(boxes, scores), 200)
    return (*_sorted(boxes, scores), 120)


TILED_CASES = ["clustered", "ties", "degenerate", "k_below_tile", "k_ragged",
               "max_det_above_n_pos", "one_cluster"]


@pytest.mark.parametrize("case", TILED_CASES)
def test_plain_emit_once_matches_tiled_keep(case):
    """On sorted candidates, the emit-once loop equals the JAX default keep:
    ``_tiled_keep`` (at the kernel's tile of 128) then ``_emit_topk_kept``."""
    boxes, scores, max_det = _tiled_candidates(case)
    B, K = scores.shape
    iou = 0.5
    kept = jax.vmap(partial(_tiled_keep, iou_thres=iou, max_det=max_det, tile=128))(
        jnp.asarray(boxes), jnp.asarray(scores))
    cand_idx = jnp.broadcast_to(jnp.arange(K, dtype=jnp.float32), (B, K))
    dets, valid_j = jax.vmap(partial(_emit_topk_kept, max_det=max_det))(
        jnp.asarray(boxes), jnp.asarray(scores), cand_idx, kept)
    dets, valid_j = np.asarray(dets), np.asarray(valid_j)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    idx, valid = greedy_nms_plain(b, s, max_det, iou, emit_once=True)
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    np.testing.assert_array_equal(idx.numpy(), dets[..., 5].astype(np.int32))
    n_pos = (scores > 0).sum(1)
    if case == "max_det_above_n_pos":
        assert (valid.sum(1).numpy() < max_det).all() and (n_pos < max_det).all()
    elif case == "one_cluster":
        assert 0 < valid.sum() < B * max_det // 2  # the cluster suppresses most of itself
    else:  # many rows, not a short chain
        assert valid.sum() > B * min(max_det, K) // 4
    kept_idx = idx.numpy()[0][valid.numpy()[0]]
    assert len(kept_idx) == len(set(kept_idx.tolist()))  # each box at most once
    if case == "degenerate":  # the Pallas rule repeats a degenerate box here
        idx_p, _ = greedy_nms_plain(b, s, max_det, iou, emit_once=False)
        assert not torch.equal(idx_p, idx)


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


@pytest.mark.parametrize("emit_once", [True, False], ids=["emit_once", "pallas_rule"])
@pytest.mark.parametrize("zero_area", [0, 5], ids=["clustered", "zero_area_boxes"])
def test_greedy_nms_wrapper_sorts_unsorted_candidates(zero_area, emit_once):
    """A direct caller's unsorted candidates: the wrapper stable-sorts them,
    runs the op (whose precondition is that order) and maps ``idx`` back,
    which equals the plain loop on the unsorted input and, under the Pallas
    rule, the Pallas kernel in interpret mode (sort, then compare)."""
    boxes, scores = clustered_candidates(4, B=2, K=384, zero_area=zero_area)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    idx, valid = greedy_nms(b, s, 80, 0.5, emit_once=emit_once)
    want_idx, want_valid = greedy_nms_plain(b, s, 80, 0.5, emit_once=emit_once)
    assert torch.equal(idx, want_idx) and torch.equal(valid, want_valid)
    assert valid.sum() > 40
    if not emit_once:
        rows, valid_p = pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), 80, 0.5,
                                          interpret=True)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_p))
        np.testing.assert_array_equal(
            idx.numpy(), np.where(valid_p, np.asarray(rows)[..., 5], 0).astype(np.int32))


@pytest.mark.parametrize("emit_once", [True, False], ids=["emit_once", "pallas_rule"])
def test_registered_op_matches_plain(emit_once):
    """``torch.ops.yolov6.greedy_nms`` on sorted CPU candidates is the plain
    version, and its fake implementation gives the output shapes and types."""
    boxes, scores = (torch.from_numpy(a) for a in _sorted(*clustered_candidates(5, B=3, K=300)))
    got = torch.ops.yolov6.greedy_nms(boxes, scores, 60, 0.45, emit_once)
    want = greedy_nms_plain(boxes, scores, 60, 0.45, emit_once=emit_once)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = torch.ops.yolov6.greedy_nms(mode.from_tensor(boxes), mode.from_tensor(scores), 60,
                                           0.45, emit_once)
    assert [(tuple(t.shape), t.dtype) for t in fake] == [((3, 60), torch.int32),
                                                         ((3, 60), torch.bool)]


def test_export_records_the_keep_as_one_node():
    """``torch.export`` of ``non_max_suppression`` records the keep as one
    ``yolov6.greedy_nms`` node, and the exported program keeps as the eager
    function does."""
    preds = torch.from_numpy(_preds(7))

    class Nms(torch.nn.Module):
        def forward(self, p):
            return non_max_suppression(p, 0.25, 0.45, max_det=50)

    ep = torch.export.export(Nms(), (preds,))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("yolov6.greedy_nms.default") == 1
    # the selection's class argmax alone: the plain loop's 50 steps are not in the graph
    assert targets.count("aten.argmax.default") == 1
    got, want = ep.module()(preds), non_max_suppression(preds, 0.25, 0.45, max_det=50)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


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


def _degenerate_preds(kind, seed=0):
    """One image of 200 anchors, one of them a zero-area or inverted box
    (negative w and h, as the decode of a raw regression gives) with class
    score 0.99."""
    pred = _preds(seed, B=1, A=200)
    pred[0, 7, 2:4] = (0.0, 25.0) if kind == "zero_area" else (-20.0, -30.0)
    pred[0, 7, 4] = 1.0
    pred[0, 7, 5:] = 0.0
    pred[0, 7, 8] = 0.99
    return pred


# (port method, JAX method); JAX 'pallas' runs only on a TPU, its rule is the
# JAX 'loop' rule
DEGENERATE_METHODS = [(None, None), ("tiled", None), ("loop", "loop"), ("pallas", "loop")]


@pytest.mark.parametrize("kind", ["inverted", "zero_area"])
@pytest.mark.parametrize("methods", DEGENERATE_METHODS,
                         ids=["default", "tiled", "loop", "pallas"])
def test_degenerate_box_nms_matches_jax(kind, methods):
    port_method, jax_method = methods
    pred = _degenerate_preds(kind)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=30)
    dets_j, valid_j = jax_nms(jnp.asarray(pred), exact_topk=True, method=jax_method, **kw)
    dets_t, valid_t = non_max_suppression(torch.from_numpy(pred), method=port_method, **kw)
    dets_j, valid_j = np.asarray(dets_j), np.asarray(valid_j)
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    np.testing.assert_array_equal(dets_t.numpy(), dets_j)
    rows = np.flatnonzero(dets_j[0, :, 4] == np.float32(0.99))
    # emitted once under the default rule; from its first row on, every row
    # under the Pallas rule
    assert len(rows) == (1 if jax_method is None else kw["max_det"] - rows[0])


@pytest.mark.parametrize("method", ["perclass"])
def test_unported_keep_methods_raise(method):
    """``'perclass'`` is accepted (with JAX's ``class_cap``) and gives the
    default keep's output."""
    pred = torch.from_numpy(_preds(0, A=20))
    got = non_max_suppression(pred, method=method, class_cap=4)
    want = non_max_suppression(pred)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_unknown_keep_method_is_rejected():
    with pytest.raises(ValueError):
        non_max_suppression(torch.from_numpy(_preds(0, A=20)), method="argmax")


# (id, predictions, kwargs of both sides): JAX's 'perclass' on its Jacobi
# path (no class over class_cap), on its in-graph fall back to the tiled keep
# (class_cap 4), and on its static fall backs (agnostic, one class)
PERCLASS_CASES = [
    ("no_overflow", lambda: _preds(11), dict(conf_thres=0.03, iou_thres=0.65, max_det=300,
                                             max_nms=2048, multi_label=True)),
    ("overflow_small_class_cap", lambda: _preds(12),
     dict(conf_thres=0.03, iou_thres=0.65, max_det=300, max_nms=2048, multi_label=True,
          class_cap=4)),
    ("agnostic", lambda: _preds(13), dict(conf_thres=0.1, iou_thres=0.45, max_det=100,
                                          agnostic=True)),
    ("one_class", lambda: _preds(14, nc=1), dict(conf_thres=0.25, iou_thres=0.45, max_det=100)),
    ("multi_label_topk", lambda: _preds(15), dict(conf_thres=0.03, iou_thres=0.65, max_det=300,
                                                  max_nms=2048, multi_label=True,
                                                  row_select="topk")),
    ("inverted", lambda: _degenerate_preds("inverted"), dict(conf_thres=0.25, iou_thres=0.45,
                                                             max_det=30)),
    ("zero_area", lambda: _degenerate_preds("zero_area"), dict(conf_thres=0.25, iou_thres=0.45,
                                                               max_det=30)),
]


@pytest.mark.parametrize("case", PERCLASS_CASES, ids=[c[0] for c in PERCLASS_CASES])
def test_perclass_matches_jax_perclass(case):
    """The port's ``'perclass'`` gives JAX's ``'perclass'`` detections and
    valid mask exactly, and the port's default keep's output."""
    _, make, kw = case
    pred = make()
    dets_j, valid_j = jax_nms(jnp.asarray(pred), exact_topk=True, method="perclass", **kw)
    dets_t, valid_t = non_max_suppression(torch.from_numpy(pred), method="perclass", **kw)
    valid_j, dets_j = np.asarray(valid_j), np.asarray(dets_j)
    assert valid_j.sum() > 0
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    np.testing.assert_array_equal(dets_t.numpy(), dets_j)
    base = {k: v for k, v in kw.items() if k != "class_cap"}
    dets_d, valid_d = non_max_suppression(torch.from_numpy(pred), **base)
    assert torch.equal(valid_d, valid_t) and torch.equal(dets_d, dets_t)
