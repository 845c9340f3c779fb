"""The training recipes' losses against the JAX package, on the CPU in fp32:
``ComputeLossAB`` (fuse-AB), ``ComputeLossDistill`` (M/L, on TAL and on
ATSS, with and without the channel-wise KD, at epochs 0, 150 and 300 of
300), ``ComputeLossDistillNS`` and each KD function alone, values and
gradients.

Inputs are made from numpy seeds at 64 px (84 anchor-free anchors, 252
anchor-based ones) with 4 classes, M=8 padded GT rows and one image without
GT; one batch has only padding and one a single box whose positives' target
scores sum to less than 1, so that the denominator guard
(``target_scores_sum > 0``, where the main loss has ``> 1``) takes each of
its sides. The DFL KD uses M's ``reg_max=16``. The
neck maps are 8, 16 and 32 channels. Tolerances: the loss and every
component rtol 1e-5 + atol 1e-6 (the per-anchor DFL KD alone: its sum so,
each anchor's value rtol 1e-4, see the test); each gradient (autograd against
``jax.grad``), with respect to every prediction input, within 1e-4 of the
JAX gradient's largest magnitude (+ 1e-12 for a gradient of zeros).
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.losses import loss_distill as jdistill
from yolov6_tpu.losses.loss_distill_ns import ComputeLossDistillNS as JaxLossDistillNS
from yolov6_tpu.losses.loss_fuseab import ComputeLossAB as JaxLossAB

from yolov6_tpu_torch.losses import loss_distill as tdistill
from yolov6_tpu_torch.losses.loss_distill_ns import ComputeLossDistillNS
from yolov6_tpu_torch.losses.loss_fuseab import ComputeLossAB

IMG, NC, M, REG_MAX = 64, 4, 8, 16
STRIDES = (8, 16, 32)
FEATS = [(IMG // s, IMG // s) for s in STRIDES]
A = sum(h * w for h, w in FEATS)  # 84
NECK_C = (8, 16, 32)
ANCHORS_INIT = ((10, 13, 19, 19, 33, 23), (30, 61, 59, 59, 59, 119),
                (116, 90, 185, 185, 373, 326))
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _targets(kind="labels", box=0.25):
    """[3, M, 5] padded targets: ``labels``: image 0 has 3 boxes, image 1 has
    4 (one covering most of the image), image 2 none; ``padding_only``;
    ``one_box``: a single ``box``-sized square around an anchor point of
    image 0, whose positives' target scores sum to less than 1 with this
    file's predictions."""
    t = np.zeros((3, M, 5), np.float32)
    t[:, :, 0] = -1
    if kind == "labels":
        t[0, :3] = [[0, 0.3, 0.3, 0.3, 0.4], [2, 0.7, 0.6, 0.35, 0.3], [1, 0.5, 0.5, 0.2, 0.2]]
        t[1, :4] = [[3, 0.5, 0.5, 0.9, 0.9], [0, 0.25, 0.75, 0.3, 0.3],
                    [1, 0.75, 0.25, 0.4, 0.25], [2, 0.6, 0.6, 0.15, 0.2]]
    elif kind == "one_box":
        t[0, 0] = [1, 0.4375, 0.4375, box, box]
    return t


def _close_grad(got, want, what):
    got = np.zeros_like(want) if got is None else got
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()) + 1e-12, (what, err,
                                                             float(np.abs(want).max()))


def _nchw(x):
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


# ------------------------------------------------------------------ fuse-AB


def _ab_inputs(seed):
    """Sigmoid class scores [3, 3A, NC] and xywh boxes [3, 3A, 4] in stride
    units (xy offsets around the anchor point, wh positive)."""
    rng = np.random.default_rng(seed)
    scores = 1 / (1 + np.exp(-rng.normal(-1.0, 1.5, (3, 3 * A, NC))))
    xy = rng.normal(0.0, 0.6, (3, 3 * A, 2))
    wh = rng.uniform(0.3, 6.0, (3, 3 * A, 2))
    return scores.astype(np.float32), np.concatenate([xy, wh], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["labels", "padding_only", "one_box"])
@pytest.mark.parametrize("iou_type", ["giou", "siou"])
def test_loss_ab_matches_jax(iou_type, kind):
    scores, distri = _ab_inputs(41)
    targets = _targets(kind)
    jloss = JaxLossAB(num_classes=NC, ori_img_size=IMG, iou_type=iou_type,
                      anchors_init=ANCHORS_INIT)

    def f(s, d):
        return jloss(FEATS, s, d, jnp.asarray(targets), IMG, IMG)

    (loss_j, comp_j), grads_j = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(scores), jnp.asarray(distri))
    s_t = torch.from_numpy(scores).requires_grad_()
    d_t = torch.from_numpy(distri).requires_grad_()
    loss_t, comp_t = ComputeLossAB(num_classes=NC, ori_img_size=IMG, iou_type=iou_type,
                                   anchors_init=ANCHORS_INIT)(
        FEATS, s_t, d_t, torch.from_numpy(targets), IMG, IMG)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), **LOSS_TOL)
    np.testing.assert_allclose(comp_t.numpy(), np.asarray(comp_j), **LOSS_TOL)
    assert float(comp_t[1]) == 0.0  # no DFL in the anchor-based branch
    if kind == "padding_only":  # no positive: the IoU term vanishes, the class
        assert float(comp_t[0]) == 0.0 and float(comp_t[2]) > 0  # term is the negatives'
    else:
        assert float(comp_t[0]) > 0
    _close_grad(s_t.grad.numpy(), np.asarray(grads_j[0]), "d/d scores")
    _close_grad(d_t.grad.numpy(), np.asarray(grads_j[1]), "d/d boxes")


# ------------------------------------------------------------- distillation


def _head_maps(rng, ns: bool):
    """Head maps NHWC: class logits, and box maps: a DFL distribution of 17
    bins a side for M/L; for NS plain ltrb distances plus the distribution
    branch ``reg_dist``."""
    out = {"cls": [rng.normal(-1.5, 1.5, (3, h, w, NC)) for h, w in FEATS]}
    dist = [rng.normal(0.0, 2.0, (3, h, w, 4 * (REG_MAX + 1))) for h, w in FEATS]
    if ns:
        out["reg"] = [rng.uniform(0.3, 2.5, (3, h, w, 4)) for h, w in FEATS]
        out["reg_dist"] = dist
    else:
        out["reg"] = dist
    return {k: [m.astype(np.float32) for m in v] for k, v in out.items()}


def _distill_inputs(seed, ns):
    rng = np.random.default_rng(seed)
    student, teacher = _head_maps(rng, ns), _head_maps(rng, False)
    s_feats = [rng.normal(0, 1.0, (3, h, w, c)).astype(np.float32)
               for (h, w), c in zip(FEATS, NECK_C)]
    t_feats = [(f + rng.normal(0, 0.5, f.shape)).astype(np.float32) for f in s_feats]
    return student, teacher, s_feats, t_feats


def check_distill_against_jax(ns, use_atss, distill_feat, epoch, kind="labels", seed=51):
    student, teacher, s_feats, t_feats = _distill_inputs(seed, ns)
    targets = _targets(kind, box=0.5)
    kw = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=True, reg_max=REG_MAX,
              iou_type="giou", distill_feat=distill_feat, max_epoch=300, temperature=20)
    jloss = (JaxLossDistillNS if ns else jdistill.ComputeLossDistill)(**kw)
    tloss = (ComputeLossDistillNS if ns else tdistill.ComputeLossDistill)(**kw)

    jt = jax.tree_util.tree_map(jnp.asarray, (teacher, t_feats, targets))

    def f(head, feats):
        return jloss(FEATS, head, jt[0], feats, jt[1], jt[2], jnp.asarray(epoch, jnp.float32),
                     IMG, IMG, use_atss)

    (loss_j, comp_j), (g_head, g_feats) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, student), [jnp.asarray(x) for x in s_feats])

    head_t = {k: [torch.from_numpy(_nchw(m)).requires_grad_() for m in v]
              for k, v in student.items()}
    feats_t = [torch.from_numpy(_nchw(x)).requires_grad_() for x in s_feats]
    t_head = {k: [torch.from_numpy(_nchw(m)) for m in v] for k, v in teacher.items()}
    t_feats_t = [torch.from_numpy(_nchw(x)) for x in t_feats]
    loss_t, comp_t = tloss(FEATS, head_t, t_head, feats_t, t_feats_t, torch.from_numpy(targets),
                           epoch, IMG, IMG, use_atss)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), **LOSS_TOL)
    np.testing.assert_allclose(comp_t.numpy(), np.asarray(comp_j), **LOSS_TOL)
    for key, maps in head_t.items():
        for i, m in enumerate(maps):
            got = None if m.grad is None else m.grad.permute(0, 2, 3, 1).numpy()
            _close_grad(got, np.asarray(g_head[key][i]), f"d/d {key}.{i}")
    for i, x in enumerate(feats_t):
        got = None if x.grad is None else x.grad.permute(0, 2, 3, 1).numpy()
        _close_grad(got, np.asarray(g_feats[i]), f"d/d neck.{i}")
    return loss_t, comp_t, (head_t, t_head, feats_t, t_feats_t, targets, tloss)


@pytest.mark.parametrize("epoch", [0, 150, 300])
@pytest.mark.parametrize("distill_feat", [False, True], ids=["no_cwd", "cwd"])
@pytest.mark.parametrize("assigner", ["tal", "atss"])
def test_loss_distill_matches_jax(assigner, distill_feat, epoch):
    """M/L: VFL + IoU + DFL with the class and DFL KD (and the channel-wise
    KD), decayed by the cosine of the epoch: 1 at 0, 0.505 at 150, 0.01 at
    300."""
    _, comp, _ = check_distill_against_jax(False, assigner == "atss", distill_feat, epoch)
    assert (float(comp[3]) > 0) == distill_feat
    assert all(float(c) > 0 for c in comp[:3])


def test_loss_distill_takes_the_epoch_as_a_device_scalar():
    """The Trainer passes the epoch as a scalar tensor: the same loss as the
    number."""
    loss_n, comp_n, (head, t_head, feats, t_feats, targets, tloss) = check_distill_against_jax(
        False, False, True, 150)
    loss_s, comp_s = tloss(FEATS, head, t_head, feats, t_feats, torch.from_numpy(targets),
                           torch.tensor(150.0), IMG, IMG, False)
    assert torch.equal(loss_s.detach(), loss_n.detach()) and torch.equal(comp_s, comp_n)


@pytest.mark.parametrize("distill_feat", [False, True], ids=["no_cwd", "cwd"])
@pytest.mark.parametrize("assigner", ["tal", "atss"])
def test_loss_distill_ns_matches_jax(assigner, distill_feat):
    """N/S: DFL and its KD on the ``reg_dist`` branch, the IoU losses of both
    branches summed, at epoch 100 of 300."""
    check_distill_against_jax(True, assigner == "atss", distill_feat, 100)


@pytest.mark.parametrize("kind", ["padding_only", "one_box"])
@pytest.mark.parametrize("ns", [False, True], ids=["distill", "distill_ns"])
def test_loss_distill_denominator_guard_matches_jax(ns, kind):
    """No GT in the batch: the guard puts 1 in the denominator, the IoU and
    DFL terms vanish, the class loss and the class KD remain. One box whose
    target scores sum to less than 1: the sum itself divides."""
    _, comp, _ = check_distill_against_jax(ns, False, True, 150, kind=kind)
    assert (float(comp[0]) == 0.0) == (kind == "padding_only") and float(comp[2]) > 0


def test_kd_functions_match_jax():
    """Each KD term alone, value and gradient: the class KD over post-sigmoid
    scores, the per-anchor DFL KD at T=20, the channel-wise KD over the
    spatial axis of each channel."""
    rng = np.random.default_rng(61)
    s = (1 / (1 + np.exp(-rng.normal(-1, 2, (3, A, NC))))).astype(np.float32)
    t = (1 / (1 + np.exp(-rng.normal(-1, 2, (3, A, NC))))).astype(np.float32)
    want, g = jax.value_and_grad(lambda a: jdistill.distill_loss_cls(a, t, NC, 20))(
        jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    got = tdistill.distill_loss_cls(st, torch.from_numpy(t), NC, 20)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    _close_grad(st.grad.numpy(), np.asarray(g), "class KD")

    s = rng.normal(0, 2, (3, A, 4, REG_MAX + 1)).astype(np.float32)
    t = rng.normal(0, 2, (3, A, 4, REG_MAX + 1)).astype(np.float32)
    fn = lambda a: jdistill.distill_loss_dfl_per_anchor(a, t, 20, REG_MAX)  # noqa: E731
    want = fn(jnp.asarray(s))
    g = jax.grad(lambda a: (fn(a) * jnp.arange(A)).sum())(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    got = tdistill.distill_loss_dfl_per_anchor(st, torch.from_numpy(t), 20, REG_MAX)
    assert got.shape == (3, A)
    (got * torch.arange(A)).sum().backward()
    # the sum, as the loss consumes it, at the loss's tolerance; each
    # anchor's value at 1e-4: at T=20 the bins are near uniform, and the two
    # logs, each about -log(17), cancel to about 1% of their size, so fp32
    # rounding in the two libraries' log-softmaxes leaves ~3e-5 of each value
    np.testing.assert_allclose(float(got.sum()), float(want.sum()), **LOSS_TOL)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    _close_grad(st.grad.numpy(), np.asarray(g), "DFL KD")

    s_feats = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32) for (h, w), c in
               zip(FEATS, NECK_C)]
    t_feats = [rng.normal(0, 1, f.shape).astype(np.float32) for f in s_feats]
    want, g = jax.value_and_grad(lambda a: jdistill.distill_loss_cw(a, t_feats))(
        [jnp.asarray(f) for f in s_feats])
    st = [torch.from_numpy(_nchw(f)).requires_grad_() for f in s_feats]
    got = tdistill.distill_loss_cw(st, [torch.from_numpy(_nchw(f)) for f in t_feats])
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    for i, x in enumerate(st):
        _close_grad(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g[i]), f"CW KD {i}")
