"""The port's data-parallel train step on the CPU: two gloo ranks at a
global batch of 8 (4 a rank) against one process at 8, in every mode of the
JAX package's SPMD contract (tests/test_train_step_spmd_modes.py), and the
2-rank step against the JAX step itself.

Sizes are the contract's: depth 0.33, width 0.125, 64 px, 3 classes, up to
6 boxes an image, the contract's jittered boxes (no TAL top-k tie to flip),
the port's own init under a seed (the contract's ``model.init``), fp32. One spawn of two ranks runs
every mode and returns its results; the one-process steps run here. Modes:
TAL (N), ATSS warmup (N), DFL (M, reg_max 16), fuse-AB (S), distill-NS (S
with DFL against a fuse-AB teacher, epoch 1) and its channel-wise KD, all on
the single-step branch (batch_size 64, 5 warmup steps, 3 steps), plus TAL on
the accumulation branch (batch_size 8: apply, hold, hold) and TAL with a
non-finite step (an ``inf`` in a conv weight of rank 1 only, the one process
poisoned alike), held on every rank, then a clean step.

Tolerances, the contract's: the step-0 loss within rtol 1e-4; the
parameters and BN running statistics after step 0 within rtol 2e-3, atol
1e-6, per element, or for the channel-wise KD (chaotic under reduction-order
noise, as in JAX) the global step-0 update's norm ratio in (0.93, 1.07) and
cosine > 0.98, which every mode must also meet; the 3-step loss trajectory
within rtol 2e-3; counters equal; both ranks' states bit-equal.

The slice as a whole: two ranks (1 image each) take the TAL step of
tests/test_torch_train_step.py's spec (small S, b2@64, accumulation branch,
epoch 10 of 10), so that the JAX step traced there is the same program and
shares its compile cache; each parameter's step-0 change is held within
1e-3 of the JAX change's largest magnitude + 1e-7, each BN statistic within
1e-4 of the JAX leaf's + 1e-6, the loss within rtol 1e-4.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.losses.loss_distill_ns import ComputeLossDistillNS
from yolov6_tpu_torch.losses.loss_fuseab import ComputeLossAB
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver.build import scale_hyperparams_for_batch
from yolov6_tpu_torch.utils.config import Config

from torch_dist_utils import run_ranks
from torch_port_utils import REPO_ROOT, small_s_config

IMG, NC, BATCH, MAX_GT, WORLD = 64, 3, 8, 6, 2
SOLVER = dict(lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.0005, warmup_epochs=3.0,
              warmup_momentum=0.8, warmup_bias_lr=0.1, lr_scheduler="Cosine")
# name -> (config, build_model kwargs, loss, use_atss, epoch, step batch_size, steps)
MODES = {
    "tal": ("n", {}, "siou", False, 0.0, 64, 3),
    "atss_warmup": ("n", {}, "siou", True, 0.0, 64, 3),
    "dfl": ("m", {}, "dfl", False, 0.0, 64, 3),
    "fuse_ab": ("s", dict(fuse_ab=True), "giou", False, 0.0, 64, 3),
    "distill_ns": ("s_dfl", dict(distill_ns=True), "distill", False, 1.0, 64, 3),
    "distill_ns_cwd": ("s_dfl", dict(distill_ns=True), "distill_cwd", False, 1.0, 64, 1),
    "accumulate": ("n", {}, "siou", False, 0.0, 8, 3),
    "nonfinite": ("n", {}, "siou", False, 0.0, 64, 3),
}
CHAOTIC = {"distill_ns_cwd"}


def contract_config(name):
    """The contract's cut (depth 0.33, width 0.125) of configs/yolov6{n,s,m}.py;
    ``s_dfl`` is S with DFL (reg_max 16), the distill-NS student's config."""
    cfg = Config.fromfile(os.path.join(REPO_ROOT, "configs", f"yolov6{name[0]}.py"))
    cfg.model.depth_multiple, cfg.model.width_multiple = 0.33, 0.125
    if name == "s_dfl":
        cfg.model.head.use_dfl, cfg.model.head.reg_max = True, 16
    return cfg


def contract_batch():
    """The contract's images and jittered targets (tests/test_train_step_spmd_modes.py:38-66)."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (BATCH, IMG, IMG, 3), np.uint8)
    targets = np.full((BATCH, MAX_GT, 5), -1.0, np.float32)
    targets[..., 1:] = 0.0
    for i in range(BATCH):
        targets[i, 0] = [i % NC, 0.37 + 0.031 * i, 0.53 - 0.027 * i, 0.23 + 0.041 * i,
                         0.31 + 0.019 * i]
        targets[i, 1] = [(i + 1) % NC, 0.71 - 0.023 * i, 0.29 + 0.037 * i, 0.17 + 0.013 * i,
                         0.43 - 0.021 * i]
    return images, targets


def _losses(kind, cfg):
    head = cfg.model.head
    if kind == "siou" or kind == "giou":
        return ComputeLoss(num_classes=NC, ori_img_size=IMG, warmup_epoch=4, use_dfl=False,
                           reg_max=0, iou_type=kind), None
    if kind == "dfl":
        return ComputeLoss(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=True,
                           reg_max=16, iou_type=head.iou_type), None
    return None, ComputeLossDistillNS(
        num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=True, reg_max=16,
        iou_type="giou", distill_feat=kind == "distill_cwd", max_epoch=10, temperature=20.0)


def _state(step):
    return {k: v.detach().clone() for k, v in step.model.state_dict().items()}


def run_mode(mode, weights, images, targets, part=slice(None)):
    """``MODES[mode]``'s steps on ``images[part]``; returns the losses, the
    model's state before, after step 0 and at the end, the counters, and for
    ``nonfinite`` whether the poisoned step left the state as it was. In a
    group of two, rank 1 alone poisons its weight in ``nonfinite``."""
    import torch.distributed as dist

    cfg_name, kw, loss_kind, use_atss, epoch, batch_size, n_steps = MODES[mode]
    cfg = contract_config(cfg_name)
    torch.manual_seed(0)
    model = build_model(cfg, num_classes=NC, deploy=False, device="cpu", **kw)
    model.load_state_dict(weights["student"], strict=True)
    loss, distill = _losses(loss_kind, cfg)
    extra = {}
    if kw.get("fuse_ab"):
        extra["compute_loss_ab"] = ComputeLossAB(
            num_classes=NC, ori_img_size=IMG, iou_type="giou",
            anchors_init=tuple(map(tuple, cfg.model.head.anchors_init)))
    if distill is not None:
        teacher = build_model(cfg, num_classes=NC, deploy=False, device="cpu", fuse_ab=True)
        teacher.load_state_dict(weights["teacher"], strict=True)
        extra["teacher"] = (teacher, distill)
    step = make_train_step(model, loss, scale_hyperparams_for_batch(SOLVER, batch_size), 10,
                           10, batch_size, 5, (IMG, IMG), half=False, device="cpu", **extra)
    out = dict(losses=[], before=_state(step))
    images, targets = images[part], targets[part]
    poison = mode == "nonfinite" and (not dist.is_initialized() or dist.get_rank() == 1)
    for i in range(n_steps):
        if mode == "nonfinite" and i == 1:
            p = next(p for p in step.model.parameters() if p.dim() == 4)
            good, held_from = p.detach().clone(), _state(step)
            if poison:
                with torch.no_grad():
                    p.view(-1)[0] = float("inf")
        loss_i, _ = step(images, targets, epoch, use_atss=use_atss)
        out["losses"].append(float(loss_i))
        if mode == "nonfinite" and i == 1:
            with torch.no_grad():
                p.copy_(good)
            after = _state(step)
            out["held"] = all(torch.equal(after[k], v) for k, v in held_from.items()
                              if not k.endswith("num_batches_tracked"))
        if i == 0:
            out["step0"] = _state(step)
    out["end"] = _state(step)
    out["counters"] = [int(step.step), int(step.accum_count), int(step.ema_updates)]
    return out


def _rank(rank, world, weights, images, targets, jax_spec):
    per = BATCH // world
    part = slice(rank * per, (rank + 1) * per)
    out = {mode: run_mode(mode, weights[mode], images, targets, part) for mode in MODES}
    if jax_spec is not None:
        out["jax_spec"] = jax_spec_step(jax_spec, rank, world)
    return out


def jax_spec_step(spec, rank=0, world=1):
    """tests/test_torch_train_step.py's first TAL step (small S, batch_size 32,
    no warmup, epoch 10) on this rank's share of its b2 batch."""
    from yolov6_tpu_torch.utils.config import Config as PortConfig

    model = build_model(small_s_config(PortConfig), num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(spec["state"], strict=True)
    step = make_train_step(model, ComputeLoss(**spec["loss_kw"]),
                           scale_hyperparams_for_batch(spec["solver"], 32), 100, spec["epochs"],
                           32, 0, (IMG, IMG), half=False, device="cpu")
    n = len(spec["images"]) // world
    part = slice(rank * n, (rank + 1) * n)
    before = _state(step)
    loss, comp = step(spec["images"][part], spec["targets"][part], spec["epochs"])
    return dict(before=before, after=_state(step), loss=float(loss), components=comp.numpy())


def _weights(seed):
    """Every mode's student (and, for distillation, its fuse-AB teacher) at the
    port's own init under ``torch.manual_seed`` (the contract's
    ``model.init(PRNGKey(0))``), as state dicts."""
    def init(cfg_name, seed, **kw):
        torch.manual_seed(seed)
        model = build_model(contract_config(cfg_name), num_classes=NC, deploy=False,
                            device="cpu", **kw)
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    out = {}
    for mode, (cfg_name, kw, loss_kind, *_) in MODES.items():
        out[mode] = {"student": init(cfg_name, seed, **kw)}
        if loss_kind.startswith("distill"):
            out[mode]["teacher"] = init(cfg_name, seed + 1, fuse_ab=True)
    return out


@pytest.fixture(scope="module")
def runs():
    """One spawn of two ranks for every mode (and the JAX spec's step), and
    the one-process runs of every mode at the global batch."""
    from test_torch_train_step import (
        EPOCHS, LOSS_KW, S_SOLVER, _batch as spec_batch, _train_variables,
    )
    from yolov6_tpu_torch.utils.weights import state_dict_from_jax

    jmodel, variables = _train_variables(seed=21)
    images_spec, targets_spec = spec_batch()
    spec = dict(state=state_dict_from_jax(variables), loss_kw=LOSS_KW, solver=S_SOLVER,
                epochs=EPOCHS, images=images_spec, targets=targets_spec)
    weights = _weights(seed=0)
    images, targets = contract_batch()
    with ThreadPoolExecutor(1) as pool:  # the ranks run while this process steps
        ranks = pool.submit(run_ranks, _rank, WORLD, weights, images, targets, spec)
        single = {mode: run_mode(mode, weights[mode], images, targets) for mode in MODES}
        ranks = ranks.result()
    return dict(ranks=ranks, single=single, spec=spec, jax=(jmodel, variables))


def _update(before, after):
    keys = [k for k in before if before[k].is_floating_point()]
    return torch.cat([(after[k].double() - before[k].double()).reshape(-1) for k in keys])


@pytest.mark.parametrize("mode", list(MODES))
def test_two_ranks_take_the_one_process_step(runs, mode):
    one = runs["single"][mode]
    r0, r1 = (r[mode] for r in runs["ranks"])
    # the ranks hold one state, bit for bit
    for key in ("step0", "end"):
        for k, v in r0[key].items():
            assert torch.equal(v, r1[key][k]), (key, k)
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    assert r0["counters"] == r1["counters"]
    assert r0["counters"] == one["counters"]
    assert np.isfinite(one["losses"]).all() or mode == "nonfinite"
    np.testing.assert_allclose(r0["losses"][0], one["losses"][0], rtol=1e-4)

    u_one, u_two = _update(one["before"], one["step0"]), _update(r0["before"], r0["step0"])
    n_one, n_two = float(u_one.norm()), float(u_two.norm())
    assert n_one > 0 and n_two > 0
    ratio, cos = n_two / n_one, float(u_one @ u_two) / (n_one * n_two)
    assert 0.93 < ratio < 1.07, f"step-0 update norm ratio {ratio}"
    assert cos > 0.98, f"step-0 update cosine {cos}"
    if mode not in CHAOTIC:
        for k, want in one["step0"].items():
            torch.testing.assert_close(r0["step0"][k], want, rtol=2e-3, atol=1e-6,
                                       msg=lambda m, k=k: f"{mode} step 0 {k}: {m}")
        np.testing.assert_allclose(r0["losses"], one["losses"], rtol=2e-3)
    if mode == "accumulate":
        assert one["counters"] == [3, 2, 1]  # applied, held, held
    if mode == "nonfinite":
        assert r0["held"] and r1["held"] and one["held"]
        assert not np.isfinite(r0["losses"][1]) and not np.isfinite(one["losses"][1])
        assert one["counters"] == [3, 0, 2]
        for k, want in one["end"].items():
            torch.testing.assert_close(r0["end"][k], want, rtol=2e-3, atol=1e-6,
                                       msg=lambda m, k=k: f"after the clean step {k}: {m}")


def test_two_ranks_take_the_jax_step(runs):
    """The slice against the JAX package: the 2-rank step (1 image a rank)
    against the JAX step at the global batch of 2."""
    import jax
    import jax.numpy as jnp

    from test_torch_train_step import EPOCH, LOSS_KW, S_SOLVER, _close_delta, _close_leaf, \
        _jax_leaves
    from yolov6_tpu.core.train_step import create_train_state
    from yolov6_tpu.core.train_step import make_train_step as jax_make_train_step
    from yolov6_tpu.losses.loss import ComputeLoss as JaxComputeLoss
    from yolov6_tpu.solver.build import build_param_groups

    jmodel, variables = runs["jax"]
    spec = runs["spec"]
    jstep = jax_make_train_step(
        jmodel, JaxComputeLoss(**LOSS_KW), build_param_groups(variables["params"]),
        scale_hyperparams_for_batch(S_SOLVER, 32), max_stepnum=100, epochs=spec["epochs"],
        batch_size=32, warmup_stepnum=0, img_size=(IMG, IMG))
    jstate, loss_j, comp_j = jstep(create_train_state(variables),
                                   jnp.asarray(spec["images"]), jnp.asarray(spec["targets"]),
                                   jnp.asarray(EPOCH), use_atss=False)
    r0, r1 = (r["jax_spec"] for r in runs["ranks"])
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], float(loss_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r0["components"], np.asarray(comp_j), rtol=1e-4, atol=1e-6)
    j_before = _jax_leaves({"params": variables["params"]})
    j_after = _jax_leaves({"params": jax.device_get(jstate.params)})
    for name in j_after:
        got = (r0["after"][name] - r0["before"][name]).numpy()
        _close_delta(got, j_after[name] - j_before[name], f"2 ranks step 0 {name}")
    for name, want in _jax_leaves({"batch_stats": jax.device_get(jstate.batch_stats)}).items():
        _close_leaf(r0["after"][name].numpy(), want, f"2 ranks step 0 {name}")
