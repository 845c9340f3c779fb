"""The port's train anchors, TAL assigner, IoU menu, VariFocal loss and
ComputeLoss (with its gradients) against the JAX package, on the CPU in fp32.

Inputs are made from numpy seeds at the 64x64 anchor count (84 anchors over
strides 8/16/32), with M=8 padded GT rows, one image without GT, and forced
ties: inverted predicted boxes and zero scores give many anchors inside a GT
box a task-aligned metric of exactly 0, so the top-13 has to break ties.
Tolerances: anchors, masks, indices and labels exactly equal; target scores
and boxes rtol 1e-5 / atol 1e-7; IoU values and the loss rtol 1e-5 / atol
1e-6 (transcendentals of two libraries); loss gradients rtol 1e-4 / atol 1e-7.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.assigners import assigner_utils as jutils
from yolov6_tpu.assigners.anchor_generator import generate_anchors as jax_generate_anchors
from yolov6_tpu.assigners.tal_assigner import task_aligned_assigner as jax_tal
from yolov6_tpu.losses.loss import ComputeLoss as JaxComputeLoss
from yolov6_tpu.losses.loss import varifocal_loss as jax_vfl
from yolov6_tpu.ops.boxes import elementwise_box_iou as jax_iou

from yolov6_tpu_torch.assigners import assigner_utils as tutils
from yolov6_tpu_torch.assigners.anchor_generator import generate_anchors
from yolov6_tpu_torch.assigners.tal_assigner import task_aligned_assigner
from yolov6_tpu_torch.losses.loss import ComputeLoss, varifocal_loss
from yolov6_tpu_torch.ops.boxes import elementwise_box_iou

IMG, NC, M = 64, 4, 8
STRIDES = (8, 16, 32)
FEATS = [(IMG // s, IMG // s) for s in STRIDES]
A = sum(h * w for h, w in FEATS)  # 84


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _targets():
    """[3, M, 5] padded targets (cls, cx, cy, w, h normalised): image 0 has 3
    boxes, image 1 has 4 with one covering most of the image, image 2 none.
    Padded rows are cls -1, boxes 0."""
    t = np.zeros((3, M, 5), np.float32)
    t[:, :, 0] = -1
    t[0, :3] = [[0, 0.3, 0.3, 0.3, 0.4], [2, 0.7, 0.6, 0.35, 0.3], [1, 0.5, 0.5, 0.2, 0.2]]
    t[1, :4] = [[3, 0.5, 0.5, 0.9, 0.9], [0, 0.25, 0.75, 0.3, 0.3], [1, 0.75, 0.25, 0.4, 0.25],
                [2, 0.6, 0.6, 0.15, 0.2]]
    return t


def _predictions(seed=0, zero_scores=True):
    """Seeded ``pred_scores [3, A, NC]`` (after the sigmoid) and raw
    ``pred_distri [3, A, 4]`` in stride units, with the forced ties."""
    rng = np.random.default_rng(seed)
    scores = 1 / (1 + np.exp(-rng.normal(-1.0, 1.5, (3, A, NC))))
    distri = rng.uniform(0.3, 2.5, (3, A, 4))
    # image 1: most anchors predict inverted boxes (IoU 0 with every GT) and
    # class 3 scores 0 on others, so the big GT box has fewer than 13 anchors
    # of positive metric
    inverted = rng.uniform(0, 1, A) < 0.8
    distri[1, inverted] = -rng.uniform(0.1, 1.0, (int(inverted.sum()), 4))
    if zero_scores:
        scores[1, ::3, 3] = 0.0
    return scores.astype(np.float32), distri.astype(np.float32)


def _gt(targets):
    scale = np.array([IMG, IMG, IMG, IMG], np.float32)
    xywh = targets[..., 1:5] * scale
    gt_bboxes = np.concatenate([xywh[..., :2] - xywh[..., 2:] * 0.5,
                                xywh[..., :2] + xywh[..., 2:] * 0.5], -1).astype(np.float32)
    mask_gt = (gt_bboxes.sum(-1, keepdims=True) > 0).astype(np.float32)
    return targets[..., :1], gt_bboxes, mask_gt


def _pred_boxes(distri):
    """xyxy boxes in pixels from the distances, as ComputeLoss decodes them."""
    _, pts, _, strides = jax_generate_anchors(FEATS, STRIDES)
    pts, strides = np.asarray(pts), np.asarray(strides)
    ps = pts / strides
    boxes = np.concatenate([ps - distri[..., :2], ps + distri[..., 2:]], -1) * strides
    return boxes.astype(np.float32), pts


@pytest.mark.parametrize("hw", [(64, 64), (640, 640), (96, 160)])
def test_train_anchors_match_jax(hw):
    feats = [(hw[0] // s, hw[1] // s) for s in STRIDES]
    want = jax_generate_anchors(feats, STRIDES, 5.0, 0.5, is_eval=False, mode="af")
    got = generate_anchors(feats, STRIDES, 5.0, 0.5, device="cpu")
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2] == want[2]


def test_iou_calculator_and_candidates_match_jax():
    scores, distri = _predictions()
    _, gt_bboxes, _ = _gt(_targets())
    boxes, pts = _pred_boxes(distri)
    np.testing.assert_array_equal(
        tutils.iou_calculator(_t(gt_bboxes), _t(boxes)).numpy(),
        np.asarray(jutils.iou_calculator(jnp.asarray(gt_bboxes), jnp.asarray(boxes))))
    np.testing.assert_array_equal(
        tutils.select_candidates_in_gts(_t(pts), _t(gt_bboxes)).numpy(),
        np.asarray(jutils.select_candidates_in_gts(jnp.asarray(pts), jnp.asarray(gt_bboxes))))


def test_topk_mask_matches_jax_with_ties():
    """Metrics with many equal values (0 and a few repeated levels): the mask
    equals ``lax.top_k``'s, lower index first among equals."""
    rng = np.random.default_rng(3)
    metrics = rng.choice([0.0, 0.0, 0.0, 0.25, 0.5, 0.75], size=(3, M, A)).astype(np.float32)
    valid = (rng.uniform(0, 1, (3, M, 1)) < 0.7)
    got = tutils.topk_mask(_t(metrics), 13, _t(valid)).numpy()
    want = np.asarray(jutils.scatter_topk_mask(jnp.asarray(metrics), 13, jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 13 * valid.sum()


def test_topk_mask_ties_at_full_anchor_count():
    """At the 640x640 anchor count (8400) the JAX package switches to
    ``approx_max_k``; the port stays exact: each row keeps the 13 largest,
    lower index first among equals (numpy's stable sort)."""
    rng = np.random.default_rng(4)
    metrics = rng.choice([0.0, 0.0, 0.1, 0.2], size=(2, 3, 8400)).astype(np.float32)
    metrics[0, 0, :] = 0.0  # a row of ties only
    got = tutils.topk_mask(_t(metrics), 13, torch.ones(2, 3, 1)).numpy()
    idx = np.argsort(-metrics, axis=-1, kind="stable")[..., :13]
    want = np.zeros_like(metrics)
    np.put_along_axis(want, idx, 1.0, -1)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, :13].all() and got[0, 0].sum() == 13


def test_select_highest_overlaps_matches_jax():
    """Anchors claimed by several GTs, and equal IoUs: first maximum."""
    rng = np.random.default_rng(5)
    mask_pos = (rng.uniform(0, 1, (3, M, A)) < 0.3).astype(np.float32)
    overlaps = rng.choice([0.1, 0.3, 0.3, 0.6], size=(3, M, A)).astype(np.float32)
    got = tutils.select_highest_overlaps(_t(mask_pos), _t(overlaps), M)
    want = jutils.select_highest_overlaps(jnp.asarray(mask_pos), jnp.asarray(overlaps), M)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_task_aligned_assigner_matches_jax():
    scores, distri = _predictions()
    gt_labels, gt_bboxes, mask_gt = _gt(_targets())
    boxes, pts = _pred_boxes(distri)
    args = (scores, boxes, pts, gt_labels, gt_bboxes, mask_gt)
    kw = dict(topk=13, num_classes=NC, alpha=1.0, beta=6.0)
    labels_j, boxes_j, scores_j, fg_j = (np.asarray(a) for a in jax_tal(
        *(jnp.asarray(a) for a in args), **kw))
    labels_t, boxes_t, scores_t, fg_t = task_aligned_assigner(*(_t(a) for a in args), **kw)

    np.testing.assert_array_equal(fg_t.numpy(), fg_j)
    np.testing.assert_array_equal(labels_t.numpy(), labels_j)
    np.testing.assert_allclose(boxes_t.numpy(), boxes_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(scores_t.numpy(), scores_j, rtol=1e-5, atol=1e-7)
    # the image without GT has no positive; no anchor goes to a padded row
    assert not fg_j[2].any() and fg_j[0].any() and fg_j[1].any()
    for b, n_gt in ((0, 3), (1, 4)):
        assigned = boxes_j[b][fg_j[b]]
        assert (np.abs(assigned[:, None] - gt_bboxes[b, :n_gt][None]).sum(-1) == 0).any(1).all()
    # the ties were real: the big box drew positives of metric exactly 0
    metric = (np.take_along_axis(scores[1], np.full((A, 1), 3), 1)[:, 0]
              * np.asarray(jutils.iou_calculator(jnp.asarray(gt_bboxes[1:2]),
                                                 jnp.asarray(boxes[1:2])))[0, 0] ** 6)
    big = (boxes_j[1] == gt_bboxes[1, 0]).all(-1) & fg_j[1]
    assert big.sum() > 0 and (metric[big] == 0).sum() > 0


@pytest.mark.parametrize("iou_type", ["iou", "giou", "diou", "ciou", "siou"])
def test_elementwise_iou_matches_jax(iou_type):
    rng = np.random.default_rng(6)
    c1, c2 = rng.uniform(10, 50, (2, 500, 2))
    wh1, wh2 = rng.uniform(2, 30, (2, 500, 2))
    b1 = np.concatenate([c1 - wh1 / 2, c1 + wh1 / 2], -1).astype(np.float32)
    b2 = np.concatenate([c2 - wh2 / 2, c2 + wh2 / 2], -1).astype(np.float32)
    b2[:50] = b1[:50]  # equal boxes
    got = elementwise_box_iou(_t(b1), _t(b2), iou_type=iou_type, eps=1e-10).numpy()
    want = np.asarray(jax_iou(jnp.asarray(b1), jnp.asarray(b2), iou_type=iou_type, eps=1e-10))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_varifocal_loss_matches_jax():
    rng = np.random.default_rng(7)
    pred = rng.uniform(0, 1, (2, A, NC)).astype(np.float32)
    pred[0, :5] = 0.0  # log clamps at -100
    pred[1, :5] = 1.0
    gt = (rng.uniform(0, 1, (2, A, NC)) * (rng.uniform(0, 1, (2, A, NC)) < 0.1)).astype(np.float32)
    label = (gt > 0).astype(np.float32)
    got = float(varifocal_loss(_t(pred), _t(gt), _t(label)))
    want = float(jax_vfl(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(label)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


LOSS_KW = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=False, reg_max=0)


@pytest.mark.parametrize("iou_type", ["giou", "siou"])
def test_compute_loss_and_grads_match_jax(iou_type):
    """Loss, components [iou, dfl, cls], and the gradients with respect to
    the scores and the distances (torch autograd against ``jax.grad``). S
    trains with GIoU, N with SIoU. No score is exactly 0 here: there the JAX
    gradient is NaN (the clamp's zero times the log's 1/1e-44 = inf), the
    port's 0 (torch's clamp selects)."""
    scores, distri = _predictions(seed=8, zero_scores=False)
    targets = _targets()
    jloss = JaxComputeLoss(iou_type=iou_type, **LOSS_KW)

    def jfn(s, d):
        return jloss(FEATS, s, d, jnp.asarray(targets), IMG, IMG, False)

    (loss_j, comp_j), grads_j = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        jnp.asarray(scores), jnp.asarray(distri))

    s, d = _t(scores).requires_grad_(), _t(distri).requires_grad_()
    loss_t, comp_t = ComputeLoss(iou_type=iou_type, **LOSS_KW)(
        FEATS, s, d, _t(targets), IMG, IMG, False)
    loss_t.backward()

    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(comp_t.numpy(), np.asarray(comp_j), rtol=1e-5, atol=1e-6)
    assert float(comp_j[0]) > 0 and float(comp_j[1]) == 0 and float(comp_j[2]) > 0
    assert not comp_t.requires_grad
    for g, w in ((s.grad, grads_j[0]), (d.grad, grads_j[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-7)



def test_small_n_loss_and_grads_match_jax():
    """The loss of small N's train-mode outputs at N's config (SIoU, no DFL,
    TAL), and its gradients with respect to the model's outputs: the two
    packages' forwards on the same weights, each through its own loss."""
    from yolov6_tpu.models.effidehead import flatten_head_outputs as jax_flatten
    from yolov6_tpu.models.yolo import build_model as jax_build_model
    from yolov6_tpu.utils.config import Config as JaxConfig

    from yolov6_tpu_torch.models.effidehead import flatten_head_outputs
    from yolov6_tpu_torch.models.yolo import build_model
    from yolov6_tpu_torch.utils.config import Config
    from yolov6_tpu_torch.utils.weights import state_dict_from_jax

    from torch_port_utils import random_jax_variables, small_n_config

    head = small_n_config(Config).model.head
    assert head.iou_type == "siou" and not head.use_dfl
    kw = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=False, reg_max=0,
              iou_type=head.iou_type)
    jmodel = jax_build_model(small_n_config(JaxConfig), num_classes=NC, deploy=False)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=19)
    x = np.random.default_rng(20).uniform(0, 1, (3, IMG, IMG, 3)).astype(np.float32)
    targets = _targets()
    jloss = JaxComputeLoss(**kw)

    def jfn(s, d):
        return jloss(FEATS, s, d, jnp.asarray(targets), IMG, IMG, False)

    (head_j, _), _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    scores_j, distri_j = jax_flatten(head_j, NC)
    (loss_j, comp_j), grads_j = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        scores_j, distri_j)

    model = build_model(small_n_config(Config), num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        head_t, _ = model(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    scores, distri = flatten_head_outputs(head_t)
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(distri.numpy(), np.asarray(distri_j), rtol=1e-4, atol=1e-4)
    # the same inputs to both losses: the JAX outputs
    s, d = _t(np.asarray(scores_j)).requires_grad_(), _t(np.asarray(distri_j)).requires_grad_()
    loss_t, comp_t = ComputeLoss(**kw)(FEATS, s, d, _t(targets), IMG, IMG, False)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(comp_t.numpy(), np.asarray(comp_j), rtol=1e-5, atol=1e-6)
    assert float(comp_j[0]) > 0 and float(comp_j[2]) > 0
    for g, w in ((s.grad, grads_j[0]), (d.grad, grads_j[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-7)
