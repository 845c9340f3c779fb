"""The port's DFL decode and loss (``dfl_project``, ``decode_eval`` with DFL,
``bbox2dist``, ``df_loss``), its ATSS assigner (``dist_calculator``,
``atss_assigner``) and ``ComputeLoss`` with DFL on both assignment branches
against the JAX package, on the CPU in fp32.

Inputs are numpy-seeded at the 64x64 anchor count (84 anchors over strides
8/16/32) with the targets of tests/test_torch_loss.py (M=8 padded GT rows,
one image without GT), and at 640x640 (8400 anchors). The exact-tie cases
put GT centres on cell edges at integer pixels, so the distances to the cells
on either side are equal in fp32 and the top-9 must break ties as
``lax.top_k`` does, lower index first. Tolerances: masks, indices, labels,
clipped distances and assigned boxes exactly equal; distances rtol 1e-6
(XLA's CPU sqrt differs from torch's in the last bit now and then, so a
near tie may order differently: the exact-tie cases are tested apart from
the generic ones) with the same exact ties; softmax-based values (projections, decoded boxes,
df_loss) rtol 1e-5 / atol 1e-5 px or 1e-6; target scores rtol 1e-5 / atol
1e-7; the loss rtol 1e-5 / atol 1e-6 and its gradients rtol 1e-4 / atol 1e-7,
as in the S loss tests.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.assigners import assigner_utils as jutils
from yolov6_tpu.assigners.anchor_generator import generate_anchors as jax_generate_anchors
from yolov6_tpu.assigners.atss_assigner import atss_assigner as jax_atss
from yolov6_tpu.losses.loss import ComputeLoss as JaxComputeLoss
from yolov6_tpu.losses.loss import df_loss as jax_df_loss
from yolov6_tpu.models.effidehead import decode_eval as jax_decode_eval
from yolov6_tpu.models.effidehead import dfl_project as jax_dfl_project
from yolov6_tpu.ops.boxes import bbox2dist as jax_bbox2dist

from yolov6_tpu_torch.assigners import assigner_utils as tutils
from yolov6_tpu_torch.assigners.anchor_generator import generate_anchors
from yolov6_tpu_torch.assigners.atss_assigner import atss_assigner
from yolov6_tpu_torch.losses.loss import ComputeLoss, df_loss
from yolov6_tpu_torch.models.effidehead import decode_eval, dfl_project
from yolov6_tpu_torch.ops.boxes import bbox2dist

from test_torch_loss import A, FEATS, IMG, M, NC, STRIDES, _gt, _pred_boxes, _predictions, _targets
from torch_port_utils import edge_centred_targets

REG_MAX = 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _logits(seed, shape, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_dfl_project_matches_jax():
    logits = _logits(40, (3, A, 4 * (REG_MAX + 1)))
    logits[0, :5] *= 30.0  # near one-hot distributions
    got = dfl_project(_t(logits), REG_MAX).numpy()
    want = np.asarray(jax_dfl_project(jnp.asarray(logits), REG_MAX))
    assert got.shape == (3, A, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_decode_eval_with_dfl_matches_jax():
    """NHWC maps on the JAX side, the same maps NCHW on the port's: the
    channel ``side * 17 + bin`` of one is the channel of the other."""
    rng = np.random.default_rng(41)
    cls = [rng.standard_normal((2, h, w, NC)).astype(np.float32) for h, w in FEATS]
    reg = [_logits(42 + i, (2, h, w, 4 * (REG_MAX + 1))) for i, (h, w) in enumerate(FEATS)]
    want = np.asarray(jax_decode_eval({"cls": [jnp.asarray(c) for c in cls],
                                       "reg": [jnp.asarray(r) for r in reg]},
                                      NC, STRIDES, True, REG_MAX))
    nchw = {"cls": [_t(c.transpose(0, 3, 1, 2)) for c in cls],
            "reg": [_t(r.transpose(0, 3, 1, 2)) for r in reg]}
    got = decode_eval(nchw, NC, STRIDES, use_dfl=True, reg_max=REG_MAX).numpy()
    assert got.shape == want.shape == (2, A, 5 + NC)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[..., 4], want[..., 4])
    np.testing.assert_allclose(got[..., 5:], want[..., 5:], rtol=1e-6, atol=1e-7)


def test_bbox2dist_matches_jax():
    """Points inside, outside (negative distances, clipped to 0) and far
    from their boxes (clipped to reg_max - 0.01)."""
    rng = np.random.default_rng(43)
    pts = rng.uniform(0, 10, (2, A, 2)).astype(np.float32)
    c = rng.uniform(0, 10, (2, A, 2))
    wh = rng.uniform(0.5, 40, (2, A, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    got = bbox2dist(_t(pts), _t(boxes), REG_MAX).numpy()
    want = np.asarray(jax_bbox2dist(jnp.asarray(pts), jnp.asarray(boxes), REG_MAX))
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got == np.float32(REG_MAX - 0.01)).any()


def test_df_loss_and_grad_match_jax():
    """Targets at whole bins, between bins, and at the top clip."""
    logits = _logits(44, (3, A, 4, REG_MAX + 1))
    target = np.random.default_rng(45).uniform(0, REG_MAX - 0.01, (3, A, 4)).astype(np.float32)
    target[0, :10] = np.floor(target[0, :10])
    target[1, :10] = np.float32(REG_MAX - 0.01)
    want, want_grad = jax.value_and_grad(
        lambda x: jnp.sum(jax_df_loss(x, jnp.asarray(target), REG_MAX) ** 2))(jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    got = df_loss(x, _t(target), REG_MAX)
    assert got.shape == (3, A, 1)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(float((got ** 2).sum()), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jax_df_loss(jnp.asarray(logits), jnp.asarray(target),
                                                      REG_MAX)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-7)


def test_dist_calculator_matches_jax():
    """Distances within rtol 1e-6, anchor centres exactly equal. XLA's CPU
    sqrt is not torch's: with integer box corners (exact sums of squares) 2
    of 840 distances still differ by 1 ulp. Equal sums give equal
    distances on each side, so both sides see the same exact ties."""
    rng = np.random.default_rng(46)
    gt = np.sort(rng.uniform(0, 64, (10, 2, 2)), 1).reshape(10, 4)
    anchors = np.asarray(jax_generate_anchors(FEATS, STRIDES)[0])
    for boxes in (gt.astype(np.float32), np.round(gt).astype(np.float32)):
        got_d, got_p = tutils.dist_calculator(_t(boxes), _t(anchors))
        want_d, want_p = (np.asarray(a) for a in jutils.dist_calculator(jnp.asarray(boxes),
                                                                        jnp.asarray(anchors)))
        got_d = got_d.numpy()
        np.testing.assert_array_equal(got_p.numpy(), want_p)
        np.testing.assert_allclose(got_d, want_d, rtol=1e-6)
        np.testing.assert_array_equal(got_d[:, :, None] == got_d[:, None, :],
                                      want_d[:, :, None] == want_d[:, None, :])


def _check_atss(feats, gt_labels, gt_bboxes, mask_gt, pd_bboxes, nc):
    """The port's and JAX's ATSS on the same inputs; returns the JAX result
    after holding the port's to it."""
    anchors, _, n_level, _ = jax_generate_anchors(feats, STRIDES)
    args = (anchors, n_level, gt_labels, gt_bboxes, mask_gt, pd_bboxes)
    want = [np.asarray(a) for a in jax.jit(
        jax_atss, static_argnames=("n_level_bboxes", "topk", "num_classes"))(
        jnp.asarray(anchors), n_level_bboxes=tuple(n_level), gt_labels=jnp.asarray(gt_labels),
        gt_bboxes=jnp.asarray(gt_bboxes), mask_gt=jnp.asarray(mask_gt),
        pd_bboxes=jnp.asarray(pd_bboxes), topk=9, num_classes=nc)]
    got = [t.numpy() for t in atss_assigner(
        *(a if isinstance(a, list) else _t(a) for a in args), topk=9, num_classes=nc)]
    labels_t, boxes_t, scores_t, fg_t = got
    labels_j, boxes_j, scores_j, fg_j = want
    np.testing.assert_array_equal(fg_t, fg_j)
    np.testing.assert_array_equal(labels_t, labels_j)
    np.testing.assert_array_equal(boxes_t, boxes_j)
    np.testing.assert_allclose(scores_t, scores_j, rtol=1e-5, atol=1e-7)
    return want


def test_atss_assigner_matches_jax():
    _, distri = _predictions(seed=47, zero_scores=False)
    gt_labels, gt_bboxes, mask_gt = _gt(_targets())
    boxes, _ = _pred_boxes(distri)
    labels, _, scores, fg = _check_atss(FEATS, gt_labels, gt_bboxes, mask_gt, boxes, NC)
    assert not fg[2].any() and fg[0].any() and fg[1].any()
    assert (labels[~fg] == NC).all() and (scores[~fg] == 0).all()


@pytest.mark.parametrize("img", [64, 640])
def test_atss_assigner_exact_ties_match_jax(img):
    """GT centres on cell edges: equal distances cross the top-9 cut, and the
    assignment (``fg_mask``, labels, target boxes) is exactly JAX's."""
    feats = [(img // s, img // s) for s in STRIDES]
    targets, gt_bboxes, mask_gt = edge_centred_targets(img, 3, 5, M, NC, seed=48 + img)
    anchors, pts, n_level, _ = (np.asarray(a) if not isinstance(a, list) else a
                                for a in jax_generate_anchors(feats, STRIDES))
    rng = np.random.default_rng(49)
    pd = np.concatenate([pts - rng.uniform(2, 60, pts.shape), pts + rng.uniform(2, 60, pts.shape)],
                        -1)[None].repeat(3, 0).astype(np.float32)
    _, _, _, fg = _check_atss(feats, targets[..., :1], gt_bboxes, mask_gt, pd, NC)
    assert fg[:2].any()
    # the ties were real: for some GT the 9th and 10th nearest of a level are equal
    d = np.asarray(jutils.dist_calculator(jnp.asarray(gt_bboxes.reshape(-1, 4)),
                                          jnp.asarray(anchors))[0])
    valid = mask_gt.reshape(-1) > 0
    start, ties = 0, 0
    for n in n_level:
        if n > 9:
            level = np.sort(d[valid, start:start + n], -1)
            ties += int((level[:, 8] == level[:, 9]).sum())
        start += n
    assert ties > 0


LOSS_KW = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=True, reg_max=REG_MAX,
               iou_type="giou")


@pytest.mark.parametrize("use_atss", [False, True], ids=["tal", "atss"])
def test_compute_loss_with_dfl_matches_jax(use_atss):
    """Loss, components [iou, dfl, cls], and the gradients with respect to
    the scores and the distributions (torch autograd against ``jax.grad``),
    on the TAL and the ATSS branch."""
    scores, _ = _predictions(seed=50, zero_scores=False)
    distri = _logits(51, (3, A, 4 * (REG_MAX + 1)))
    targets = _targets()
    jloss = JaxComputeLoss(**LOSS_KW)

    def jfn(s, d):
        return jloss(FEATS, s, d, jnp.asarray(targets), IMG, IMG, use_atss)

    (loss_j, comp_j), grads_j = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        jnp.asarray(scores), jnp.asarray(distri))
    s, d = _t(scores).requires_grad_(), _t(distri).requires_grad_()
    loss_t, comp_t = ComputeLoss(**LOSS_KW)(FEATS, s, d, _t(targets), IMG, IMG, use_atss)
    loss_t.backward()

    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(comp_t.numpy(), np.asarray(comp_j), rtol=1e-5, atol=1e-6)
    assert (np.asarray(comp_j) > 0).all() and not comp_t.requires_grad
    for g, w in ((s.grad, grads_j[0]), (d.grad, grads_j[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-7)
    assert float(d.grad.abs().max()) > 0

