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

from yolov6_tpu_torch.assigners.anchor_generator import generate_anchors
from yolov6_tpu_torch.assigners.atss_assigner import atss_assigner
from yolov6_tpu_torch.core.evaler import Evaler
from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.models.effidehead import decode_eval
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.ops import nms as nms_mod
from yolov6_tpu_torch.ops.cuda.nms_kernel import MAX_K, TILE, greedy_nms, greedy_nms_plain
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.data_config import load_data_config

from torch_port_utils import (
    N_CONFIG, clustered_candidates, edge_centred_targets, small_m_config, small_s_config,
)


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
