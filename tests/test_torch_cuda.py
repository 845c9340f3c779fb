"""The port on the card: its CUDA kernels, its DFL decode and ATSS assigner,
its training steps (S, and M with DFL), the training recipes' losses, its
Evaler and its trainer, against the same on the CPU.
Every test here needs an NVIDIA GPU and skips without one; none imports JAX,
so they run where JAX is absent:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from yolov6_tpu_torch.assigners.anchor_generator import generate_anchors
from yolov6_tpu_torch.assigners.atss_assigner import atss_assigner
from yolov6_tpu_torch.core.evaler import Evaler
from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.models.effidehead import decode_eval
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.ops import nms as nms_mod
from yolov6_tpu_torch.ops.cuda.nms_kernel import TILE, greedy_nms, greedy_nms_plain
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.data_config import load_data_config

from torch_port_utils import (
    N_CONFIG, clustered_candidates, edge_centred_targets, small_m_config, small_s_config,
)


class _KeepSpy(TorchDispatchMode):
    """Records, while active, the inputs and outputs of every
    ``yolov6::greedy_nms`` call, also from inside a loaded artifact, as
    ``(boxes, scores, max_det, iou_thres, emit_once, idx, valid)``."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.yolov6.greedy_nms.default:
            self.calls.append((*args, *out))
        return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _candidates(device, seed, B, K, **kw):
    return tuple(torch.from_numpy(a).to(device) for a in clustered_candidates(seed, B, K, **kw))


def _keep(boxes, scores, max_det, iou, emit_once, is_sorted):
    """The op itself on sorted candidates, as ``non_max_suppression`` calls
    it; the wrapper, which sorts first, on unsorted ones."""
    if is_sorted:
        return torch.ops.yolov6.greedy_nms(boxes, scores, max_det, iou, emit_once)
    return greedy_nms(boxes, scores, max_det, iou, emit_once=emit_once)


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
    """Equal idx/valid to the plain version under both rules: sorted
    candidates go to the op itself as the selection hands them over,
    unsorted ones through the wrapper's stable sort, the walk and the
    indices mapped back (sort, then compare)."""
    boxes, scores = _candidates(cuda_device, 3, B, K, n_clusters=40, n_cls=20,
                                zero_area=zero_area)
    if sort:
        boxes, scores = _sorted(boxes, scores)
    before = greedy_nms.launches
    idx, valid = _keep(boxes, scores, max_det, iou, emit_once, sort)
    want_idx, want_valid = greedy_nms_plain(boxes, scores, max_det, iou, emit_once=emit_once)
    torch.cuda.synchronize()
    assert greedy_nms.launches == before + 1
    assert torch.equal(valid, want_valid)
    assert torch.equal(idx, want_idx)
    tiles = greedy_nms.last_tiles
    assert (tiles >= 1).all() and (tiles <= -(-K // TILE)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("emit_once", [True, False], ids=["emit_once", "pallas_rule"])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_registered_op_matches_plain(cuda_device, sort, emit_once):
    """``torch.ops.yolov6.greedy_nms`` itself on the card: on sorted
    candidates it launches the kernel and equals the plain version; on
    unsorted ones, sorted by the caller first, its indices mapped back
    equal the plain version's on the unsorted input."""
    boxes, scores = _candidates(cuda_device, 5, 4, 8400, n_clusters=40, n_cls=20)
    want = greedy_nms_plain(boxes, scores, 100, 0.45, emit_once=emit_once)
    order = torch.arange(8400, device=cuda_device).expand(4, -1)
    if not sort:
        scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    else:
        boxes, scores = _sorted(boxes, scores)
        want = greedy_nms_plain(boxes, scores, 100, 0.45, emit_once=emit_once)
    before = greedy_nms.launches
    idx, valid = torch.ops.yolov6.greedy_nms(boxes, scores, 100, 0.45, emit_once)
    torch.cuda.synchronize()
    assert greedy_nms.launches == before + 1
    idx = torch.where(valid, order.gather(1, idx.long()), 0).int()
    assert torch.equal(valid, want[1]) and torch.equal(idx, want[0])


@pytest.mark.cuda
def test_kernel_takes_any_candidate_count(cuda_device):
    """With the argmax loop gone, shared memory no longer grows with K: K =
    60,000 (over the 57,856 the loop allowed) launches and equals plain."""
    boxes, scores = _sorted(*_candidates(cuda_device, 6, 2, 60000, n_clusters=40, n_cls=20))
    got = torch.ops.yolov6.greedy_nms(boxes, scores, 300, 0.65, True)
    want = greedy_nms_plain(boxes, scores, 300, 0.65)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


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
        got = _keep(boxes, scores, 150, 0.5, emit_once, sort)
        want = greedy_nms_plain(boxes, scores, 150, 0.5, emit_once=emit_once)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        outs[emit_once] = got
    assert not torch.equal(outs[True][0], outs[False][0])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["non_contiguous", "too_many_rows", "misaligned"])
def test_kernel_wrapper_rejects(cuda_device, bad):
    if bad == "non_contiguous":
        boxes, scores = _candidates(cuda_device, 4, 2, 64)
        boxes = boxes.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "misaligned":
        boxes = torch.zeros(2 * 64 * 4 + 1, device=cuda_device)[1:].view(2, 64, 4)
        scores = torch.zeros((2, 64), device=cuda_device)
    else:  # too many rows: the kept buffer, 20 bytes a row, outgrows shared memory
        boxes = torch.zeros((1, 12000, 4), device=cuda_device)
        scores = torch.zeros((1, 12000), device=cuda_device)
    max_det = 12000 if bad == "too_many_rows" else 10
    with pytest.raises(ValueError):
        torch.ops.yolov6.greedy_nms(boxes, scores, max_det, 0.5, True)


def _fp32_step_on_card_and_cpu(make_cfg, loss_kw, spread_head=False):
    """Two fp32 steps (TF32 off) of a small train graph on the card and on
    the CPU from the same weights and data (``spread_head``: the head's
    prediction convs, zero at init, drawn N(0, 0.01²) so that gradients reach
    the backbone), at epoch 1 of 10 with the step
    counter past the warmup (batch_size 32: hold, then apply at the full
    weight LR): finite, the losses equal at rtol 1e-3, and after the applied
    step each parameter's change and each momentum buffer within 1e-3 of the
    CPU leaf's largest magnitude, plus a floor of 1e-6 scaled by the LR for
    the change (1e-6 for the momentum), far below the decay's share, and 2
    ulp of the leaf's largest parameter for the change, read off fp32."""
    torch.manual_seed(0)
    cpu_model = build_model(make_cfg(Config), num_classes=3, deploy=False, device="cpu")
    if spread_head:
        with torch.no_grad():
            for name, p in cpu_model.named_parameters():
                if "_preds." in name and name.endswith(".weight"):
                    p.normal_(0.0, 0.01)
    cuda_model = build_model(make_cfg(Config), num_classes=3, deploy=False, device="cuda")
    cuda_model.load_state_dict(cpu_model.state_dict())
    before = {k: v.detach().clone() for k, v in cpu_model.named_parameters()}
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    targets = np.zeros((2, 8, 5), np.float32)
    targets[:, :, 0] = -1
    targets[0, :2] = [[0, 0.3, 0.35, 0.4, 0.5], [2, 0.7, 0.6, 0.3, 0.35]]
    targets[1, :1] = [[1, 0.4, 0.6, 0.6, 0.5]]
    solver = dict(lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.0005,
                  warmup_momentum=0.8, warmup_bias_lr=0.1)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses, steps = {}, {}
        for device, model in (("cpu", cpu_model), ("cuda", cuda_model)):
            step = make_train_step(model, ComputeLoss(**loss_kw), solver, 100, 10, 32, 0,
                                   (64, 64), half=False, device=device)
            step.step.fill_(1)  # past the warmup: the weight LR is 0.0098
            losses[device] = [step(images, targets, 1)[0].item() for _ in range(2)]
            assert int(step.ema_updates) == 1 and int(step.accum_count) == 0
            steps[device] = step
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    lr = 0.01 * (1 - (1 - math.cos(math.pi / 10)) / 2 * 0.99)  # lr0 · cosine factor at epoch 1
    assert np.isfinite(losses["cuda"]).all()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    cuda_params = dict(cuda_model.named_parameters())
    for name, p in cpu_model.named_parameters():
        moved = cuda_params[name].detach().cpu() - before[name]
        for what, got, want, floor in (
                ("change", moved, p.detach() - before[name],
                 1e-6 * lr + 2 * float(np.spacing(before[name].abs().max().numpy()))),
                ("momentum", steps["cuda"].momentum[name].cpu(), steps["cpu"].momentum[name],
                 1e-6)):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= 1e-3 * scale + floor, (name, what, err, scale)
    return steps


@pytest.mark.cuda
def test_fp32_train_step_matches_cpu(cuda_device):
    """Small S, TAL without DFL (``_fp32_step_on_card_and_cpu``)."""
    _fp32_step_on_card_and_cpu(small_s_config, dict(num_classes=3, ori_img_size=64,
                                                    warmup_epoch=0, use_dfl=False, reg_max=0))


@pytest.mark.cuda
def test_fp32_train_step_small_m_dfl_matches_cpu(cuda_device):
    """Small M (BottleRep alphas, the CSP neck), TAL with DFL, as M trains
    (``_fp32_step_on_card_and_cpu`` with the head spread); the alphas get a
    gradient."""
    steps = _fp32_step_on_card_and_cpu(small_m_config, dict(
        num_classes=3, ori_img_size=64, warmup_epoch=0, use_dfl=True, reg_max=16),
        spread_head=True)
    alphas = [n for n in steps["cuda"].param_names if n.endswith(".alpha")]
    assert len(alphas) == 8
    assert all(float(steps["cuda"].momentum[n].abs().max()) > 0 for n in alphas)


@pytest.mark.cuda
def test_dfl_decode_on_card_matches_cpu(cuda_device):
    """The DFL decode of seeded head maps (b2@640 shapes, 80 classes) on the
    card and the CPU: boxes within rtol 1e-5 / atol 1e-3 px (softmax and a
    17-term expectation in another order), scores within 1e-6."""
    rng = np.random.default_rng(1)
    feats = [(80, 80), (40, 40), (20, 20)]
    maps = {"cls": [rng.standard_normal((2, 80, h, w)).astype(np.float32) for h, w in feats],
            "reg": [(rng.standard_normal((2, 68, h, w)) * 2).astype(np.float32)
                    for h, w in feats]}
    want, got = (decode_eval({k: [torch.from_numpy(a).to(dev) for a in v] for k, v in maps.items()},
                             80, (8, 16, 32), use_dfl=True, reg_max=16).cpu()
                 for dev in ("cpu", cuda_device))
    assert got.shape == (2, 8400, 85)
    torch.testing.assert_close(got[..., :4], want[..., :4], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[..., 4:], want[..., 4:], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_atss_assigner_on_card_matches_cpu(cuda_device):
    """ATSS at 8400 anchors on the card and the CPU, GT centres on cell
    edges (exact distance ties): fg_mask, labels and target boxes exactly
    equal, soft target scores within rtol 1e-5 / atol 1e-6."""
    targets, gt_bboxes, mask_gt = edge_centred_targets(640, 4, 6, 16, 80, seed=2)
    feats = [(80, 80), (40, 40), (20, 20)]
    out = []
    for dev in ("cpu", cuda_device):
        anchors, pts, n_level, _ = generate_anchors(feats, (8, 16, 32), device=dev)
        pd = torch.cat([pts - 20.0, pts + 30.0], -1)[None].repeat(4, 1, 1)
        args = [torch.from_numpy(a).to(dev) for a in (targets[..., :1], gt_bboxes, mask_gt)]
        out.append([t.cpu() for t in atss_assigner(anchors, n_level, *args, pd, topk=9,
                                                   num_classes=80)])
    (lab_c, box_c, sc_c, fg_c), (lab_g, box_g, sc_g, fg_g) = out
    assert fg_c.any()
    assert torch.equal(fg_g, fg_c) and torch.equal(lab_g, lab_c) and torch.equal(box_g, box_c)
    torch.testing.assert_close(sc_g, sc_c, rtol=1e-5, atol=1e-6)


def _recipe_loss_inputs(seed):
    """Seeded inputs of the recipes' losses at b4@640 with 80 classes: the
    anchor-based branch's scores and boxes (25,200 anchors), the distill-NS
    student's and a teacher's head maps, neck maps, and 4 labels an image."""
    rng = np.random.default_rng(seed)
    feats = [(80, 80), (40, 40), (20, 20)]
    n_ab = 3 * sum(h * w for h, w in feats)
    ab = (1 / (1 + np.exp(-rng.normal(-3, 1.5, (4, n_ab, 80)))),
          np.concatenate([rng.normal(0, 0.6, (4, n_ab, 2)), rng.uniform(0.3, 8, (4, n_ab, 2))],
                         -1))

    def head(ns):
        out = {"cls": [rng.normal(-3, 1.5, (4, 80, h, w)) for h, w in feats]}
        dist = [rng.normal(0, 2, (4, 68, h, w)) for h, w in feats]
        if ns:
            out["reg"], out["reg_dist"] = [rng.uniform(0.3, 4, (4, 4, h, w)) for h, w in feats], dist
        else:
            out["reg"] = dist
        return out

    neck = [rng.normal(0, 1, (4, c, h, w)) for (h, w), c in zip(feats, (64, 128, 256))]
    targets = np.full((4, 16, 5), -1.0)
    targets[:, :4, 0] = rng.integers(0, 80, (4, 4))
    targets[:, :4, 1:] = rng.uniform(0.2, 0.6, (4, 4, 4))
    return feats, ab, head(True), head(False), neck, [n * 0.8 for n in neck], targets


@pytest.mark.cuda
def test_recipe_losses_on_card_match_cpu(cuda_device):
    """``ComputeLossAB`` and ``ComputeLossDistillNS`` (with the channel-wise
    KD, epoch 100 of 300) on the card and on the CPU, fp32 with TF32 off:
    the loss and every component within 1e-5 relative."""
    from yolov6_tpu_torch.losses.loss_distill_ns import ComputeLossDistillNS
    from yolov6_tpu_torch.losses.loss_fuseab import ComputeLossAB

    feats, ab, student, teacher, neck, t_neck, targets = _recipe_loss_inputs(3)
    anchors_init = Config.fromfile(N_CONFIG).model.head.anchors_init
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda_device):
            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)

            tree = lambda d: {k: [t(m) for m in v] for k, v in d.items()}  # noqa: E731
            loss_ab = ComputeLossAB(num_classes=80, anchors_init=anchors_init)(
                feats, t(ab[0]), t(ab[1]), t(targets), 640, 640)
            loss_ns = ComputeLossDistillNS(num_classes=80, distill_feat=True, max_epoch=300,
                                           temperature=20)(
                feats, tree(student), tree(teacher), [t(n) for n in neck],
                [t(n) for n in t_neck], t(targets), 100, 640, 640, False)
            out[str(dev)] = [torch.cat([loss[None], comp]).cpu() for loss, comp in (loss_ab,
                                                                                     loss_ns)]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    for name, want, got in zip(("AB", "distill-NS"), out["cpu"], out[str(cuda_device)]):
        assert bool((want[[0, 1, 3]] > 0).all()), (name, want)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7, msg=name)


def _eval_set(tmp_path, n):
    """A port-written PNG set of mixed sizes (shrunk, enlarged and as is at
    img 160)."""
    return load_data_config(generate_synth_dataset(
        str(tmp_path), n_train=0, n_val=n, img_size=160, seed=5,
        sizes=[(160, 120), (200, 150), (97, 61), (120, 160)]))


@pytest.mark.cuda
def test_evaler_perfect_mock_on_card(cuda_device, tmp_path):
    """The Evaler on the card (pinned batches, non-blocking copies, the
    one-batch pipeline) with a detector that emits the letterboxed GT
    boxes: AP50 > 0.99 and AP > 0.95."""
    data = _eval_set(tmp_path, 10)
    evaler = Evaler(data, batch_size=4, img_size=160, save_dir=str(tmp_path), device="cuda")
    loader = evaler.init_data(None, "val")
    current = {}

    class Batches:
        """The loader, noting each batch's labels for the mock."""

        def __len__(self):
            return len(loader)

        def __iter__(self):
            for batch in loader:
                current["labels"] = batch[1]
                yield batch

    def mock_infer(imgs):
        assert imgs.is_cuda and imgs.dtype == torch.uint8
        b, h, w, _ = imgs.shape
        dets = torch.zeros((b, 300, 6), device=imgs.device)
        valid = torch.zeros((b, 300), dtype=torch.bool, device=imgs.device)
        for i, lb in enumerate(current["labels"]):
            lb = torch.from_numpy(lb[lb[:, 0] >= 0]).to(imgs.device)
            cx, cy, bw, bh = lb[:, 1] * w, lb[:, 2] * h, lb[:, 3] * w, lb[:, 4] * h
            dets[i, :len(lb)] = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2,
                                             torch.full_like(cx, 0.9), lb[:, 0]], -1)
            valid[i, :len(lb)] = True
        return dets, valid

    evaler._infer = mock_infer
    rows = evaler.predict_model(None, Batches())
    assert len(rows) > 10
    ap50, ap = evaler.eval_model(rows, None, loader)
    assert ap50 > 0.99 and ap > 0.95, (ap50, ap)
    assert all(r["h2d_ms"] is not None for r in evaler.batch_split)


@pytest.mark.cuda
def test_evaler_on_card_matches_cpu_decode_and_plain_keep(cuda_device, tmp_path):
    """Small S with a spread head, fp32 with TF32 off, one batch of 4: the
    card's decode agrees with the CPU's within chip_smoke.py phase [3]'s
    decode tolerance (boxes rtol 1e-4 / atol 1e-2 px, scores atol 1e-4), and
    the card's COCO rows equal the rows its own decode gives through the
    plain emit-once keep."""
    data = _eval_set(tmp_path, 4)
    torch.manual_seed(0)
    cpu_model = build_model(small_s_config(Config), num_classes=4, device="cpu")
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if "_preds." in name:
                p.normal_(0.0, 0.05) if name.endswith(".weight") else p.uniform_(-3.0, 1.0)
    cuda_model = build_model(small_s_config(Config), num_classes=4, device="cuda")
    cuda_model.load_state_dict(cpu_model.state_dict())
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        evs = {}
        for dev, model in (("cpu", cpu_model), ("cuda", cuda_model)):
            evs[dev] = Evaler(dict(data), batch_size=4, img_size=160, half=False, device=dev)
            evs[dev].init_model(model)
        loader = evs["cuda"].init_data(None, "val")
        (imgs, _, paths, shapes, n_valid), = list(loader)
        before = greedy_nms.launches
        rows = evs["cuda"].predict_model(cuda_model, [(imgs, None, paths, shapes, n_valid)])
        assert greedy_nms.launches == before + 1 and len(rows) > 0
        imgs_dev = imgs.to(cuda_device)
        preds = evs["cuda"]._decode(imgs_dev)
        want = evs["cpu"]._decode(torch.as_tensor(imgs.numpy()))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    got = preds.cpu()
    torch.testing.assert_close(got[..., :4], want[..., :4], rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(got[..., 4:], want[..., 4:], rtol=0, atol=1e-4)
    ev = evs["cuda"]
    cands = nms_mod._select_candidates(preds, ev.conf_thres, ev.max_nms, True, False, None,
                                       row_select=ev.row_select)
    dets, valid = nms_mod._keep_and_gather(cands, greedy_nms_plain, True, ev.max_det,
                                           ev.iou_thres)
    plain_rows = ev.convert_to_coco_format(dets.cpu().numpy(), valid.cpu().numpy(), paths, shapes)
    assert rows == plain_rows


@pytest.mark.cuda
def test_trainer_on_card_matches_its_cpu_data_and_eval_launches_the_kernel(cuda_device,
                                                                           tmp_path):
    """tools/train.py on the card (N, 64 px, 8 images, 2 epochs, mosaic then
    letterbox): finite losses, one kernel launch per eval batch, and the
    loader's batches equal to the CPU trainer's (the host path is the
    same)."""
    from yolov6_tpu_torch.tools import train as train_cli

    data = generate_synth_dataset(str(tmp_path / "set"), n_train=8, n_val=4, img_size=64, nc=3,
                                  seed=0)
    trainers = {}
    for device in ("cpu", "cuda"):
        args = train_cli.get_args_parser().parse_args([
            "--data-path", data, "--conf-file", N_CONFIG, "--img-size", "64",
            "--img-floor", "64", "--batch-size", "4", "--epochs", "2", "--workers", "2",
            "--eval-final-only", "--stop_aug_last_n_epoch", "1", "--max-labels", "8",
            "--output-dir", str(tmp_path / device), "--seed", "0", "--device", device])
        greedy_nms.launches = 0
        trainers[device] = train_cli.main(args)
        launches = greedy_nms.launches
    assert launches == 1 and trainers["cuda"].eval_stats[0]["images"] == 4
    for e in trainers["cuda"].epoch_stats:
        assert all(math.isfinite(v) for v in e["mean_loss"]) and e["step_ms"] > 0
    for (imgs, labels, *_), (imgs_c, labels_c, *_) in zip(trainers["cpu"].train_loader,
                                                          trainers["cuda"].train_loader):
        np.testing.assert_array_equal(np.asarray(imgs), np.asarray(imgs_c))
        np.testing.assert_array_equal(labels, labels_c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fake_quant_on_card_matches_cpu(cuda_device, dtype):
    """The fake quantisation and its straight-through gradient on the card
    equal the CPU's bit for bit (fp32 division, round half to even), on
    every .5 tie of an 8-bit range and values past it; the per-channel
    weight step too."""
    from yolov6_tpu_torch.quant.fake_quant import fake_quant, fake_quant_per_channel

    amax = torch.tensor(1.7)
    scale = float(amax) / 127
    ties = (torch.arange(-128, 127, dtype=torch.float32) + 0.5) * scale
    x = torch.cat([torch.randn(100000, generator=torch.Generator().manual_seed(0)) * 2, ties])
    x = x.to(dtype)
    outs = []
    for dev in ("cpu", cuda_device):
        xd = x.to(dev, copy=True).requires_grad_(True)
        q = fake_quant(xd, amax.to(dev))
        (q.float() * torch.linspace(0.5, 1.5, len(x), device=dev)).sum().backward()
        outs.append((q.detach().cpu(), xd.grad.cpu()))
    assert outs[1][0].device.type == "cpu" and q.device.type == "cuda"
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    w = torch.randn((64, 32, 3, 3), generator=torch.Generator().manual_seed(1))
    assert torch.equal(fake_quant_per_channel(w), fake_quant_per_channel(w.to(cuda_device)).cpu())


@pytest.mark.cuda
def test_calibration_and_quantised_forward_on_card_match_cpu(cuda_device):
    """Small S-opt-qat (deploy): the ranges calibrated on the card equal the
    CPU's within relative 1e-5 (fp32, TF32 off), and the quantised forward
    with the CPU's ranges runs on the card (its ranges moved there) and
    agrees with the CPU's within the decode tests' map tolerance."""
    from yolov6_tpu_torch.quant.ptq import calibrate
    from yolov6_tpu_torch.quant.state import quant_mode

    from torch_port_utils import REPO_ROOT, small_config

    cfg = small_config(Config, f"{REPO_ROOT}/configs/repopt/yolov6s_opt_qat.py")
    torch.manual_seed(0)
    cpu_model = build_model(cfg, num_classes=80, deploy=True, device="cpu")
    card_model = build_model(cfg, num_classes=80, deploy=True, device=cuda_device)
    card_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8) for _ in range(2)]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = calibrate(cpu_model, batches)
        got = calibrate(card_model, batches)
        assert set(got) == set(want) and all(v.device.type == "cuda" for v in got.values())
        for key, w in want.items():
            assert abs(float(got[key]) - float(w)) <= 1e-5 * float(w), key
        x = torch.from_numpy(batches[0]).permute(0, 3, 1, 2).float() / 255.0
        with torch.no_grad(), quant_mode(cpu_model, want):
            head_cpu, _ = cpu_model(x)
        with torch.no_grad(), quant_mode(card_model, want) as q:
            assert all(v.device.type == "cuda" for v in q.amax.values())
            head_card, _ = card_model(x.to(cuda_device))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for key in ("cls", "reg"):
        for a, b in zip(head_cpu[key], head_card[key]):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_pt2_artifact_keep_on_card_matches_plain(cuda_device, tmp_path):
    """A ``.pt2`` of small S exported end2end on the card and loaded back with
    ``load_serving``: its call launches the kernel (counted from inside the
    artifact), the launch's keep equals the plain keep on the artifact's own
    candidates, and the detections equal the live fp32 serve's (TF32 off)."""
    from yolov6_tpu_torch.models.end2end import (
        export_program, export_serve_module, load_serving, make_end2end_fn,
    )

    torch.manual_seed(0)
    model = build_model(small_s_config(Config), num_classes=80, deploy=True, device=cuda_device)
    with torch.no_grad():
        for conv in list(model.detect.cls_preds) + list(model.detect.reg_preds):
            conv.weight.normal_(0, 0.05)
            conv.bias.fill_(1.0 if conv in model.detect.reg_preds else 0.0)
    path = str(tmp_path / "s.pt2")
    export_program(export_serve_module(model, with_preprocess=True, half=False), 2, (128, 128),
                   path, input_dtype=torch.uint8)
    art = load_serving(path, cuda_device)
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(cuda_device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    before = greedy_nms.launches
    try:
        with _KeepSpy() as spy:
            got = art.call(images)
        torch.cuda.synchronize()
        launches = greedy_nms.launches - before
        want = make_end2end_fn(model, with_preprocess=True, half=False, device=cuda_device)(images)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert launches == len(spy.calls) == 1
    boxes, scores, max_det, iou, emit_once, idx, valid = spy.calls[0]
    want_idx, want_valid = greedy_nms_plain(boxes, scores, max_det, iou, emit_once=emit_once)
    assert torch.equal(idx, want_idx) and torch.equal(valid, want_valid) and int(valid.sum()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-4 * 128)


@pytest.mark.cuda
def test_export_runners_on_card_match_cpu(cuda_device, tmp_path):
    """Files written by the export CLI at its default device (the card) and
    run by ``tools/infer_torchscript.py`` and ``tools/onnx_demo.py`` at
    theirs (the card): the keep launches the kernel, and the detections are
    the same runners' on the CPU (the TorchScript file traced again on the
    CPU, since a trace keeps the device of its constants). The ONNX demo
    runs a plain file (``non_max_suppression``) and an end2end one (its
    ``NonMaxSuppression`` through the keep)."""
    import os

    from yolov6_tpu_torch.tools import export as export_cli
    from yolov6_tpu_torch.tools import infer_torchscript, onnx_demo

    from torch_port_utils import REPO_ROOT, S_CONFIG

    conf = str(tmp_path / "yolov6s_small.py")
    with open(S_CONFIG) as f, open(conf, "w") as g:
        g.write(f.read() + "\nmodel['depth_multiple'] = 0.1\nmodel['width_multiple'] = 0.125\n")
    torch.manual_seed(0)
    model = build_model(Config.fromfile(conf), num_classes=4, device="cpu")
    with torch.no_grad():
        for c in list(model.detect.cls_preds) + list(model.detect.reg_preds):
            c.weight.normal_(0, 0.05)
            c.bias.fill_(1.5 if c in model.detect.reg_preds else 0.0)
    weights = str(tmp_path / "s.pt")
    torch.save(model.state_dict(), weights)

    def export(fmt, out, *extra):
        argv = ["--weights", weights, "--config", conf, "--img-size", "64", "--batch-size", "1",
                "--format", fmt, "--output", str(tmp_path / out), *extra]
        return export_cli.main(export_cli.get_args_parser().parse_args(argv))

    def by_class_then_box(d):
        return d[np.lexsort((d[:, 4], d[:, 3], d[:, 2], d[:, 1], d[:, 0], d[:, 5]))]

    jpeg = os.path.join(REPO_ROOT, "data", "images", "image1.jpg")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ts_card, ts_cpu = export("torchscript", "card.pt"), export("torchscript", "cpu.pt",
                                                                    "--device", "cpu")
        kw = dict(img_size=(64, 64), conf_thres=0.3, iou_thres=0.45)
        before = greedy_nms.launches
        got = infer_torchscript.run(jpeg, ts_card, **kw)
        assert greedy_nms.launches == before + 1
        want = infer_torchscript.run(jpeg, ts_cpu, device="cpu", **kw)
        assert len(want) > 3 and got.shape == want.shape
        got, want = by_class_then_box(got), by_class_then_box(want)
        np.testing.assert_array_equal(got[:, 5], want[:, 5])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1)
        np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-4)
        for name, extra in (("plain.onnx", ()), ("e2e.onnx", ("--end2end",))):
            path = export("onnx", name, *extra)
            argv = ["--model", path, "--source", jpeg, "--conf-thres", "0.3"]
            before = greedy_nms.launches
            got = onnx_demo.main(onnx_demo.get_args_parser().parse_args(argv))
            assert greedy_nms.launches == before + 1, name
            want = onnx_demo.main(onnx_demo.get_args_parser().parse_args(
                argv + ["--device", "cpu"]))
            assert len(want) > 3 and got.shape == want.shape, name
            got, want = by_class_then_box(got), by_class_then_box(want)
            np.testing.assert_array_equal(got[:, 5], want[:, 5])
            np.testing.assert_allclose(got[:, :5], want[:, :5], atol=1e-3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
