"""End-to-end learning gate (port of tools/learning_gate.py): the port's
loader -> train step -> EMA -> checkpoint -> Evaler -> COCO evaluation chain
has to learn detection, not only run.

    python -m yolov6_tpu_torch.tools.learning_gate --out <work dir>

writes the PNG shapes set (``data/synth_detect.py``), trains through
``tools/train.py::main``, evaluates the early, mid and final checkpoints
through ``tools/eval.py::run`` and, unless ``--skip-exact-nms``, the final one
again at the reference's exact NMS protocol (``max_nms=30000``,
``row_select="topk"``). The bar is the JAX tool's (``resolve_thresholds``):
final mAP50 above 0.75 and a gain over the earliest checkpoint above 0.20 at
30 epochs or more, 0.50 and 0.10 below. Writes ``gate_result.json`` and exits
1 when the gate fails.

``--gain-over untrained`` measures the gain from the seed-initialised model
itself, saved and evaluated before its first step (``untrained_ckpt.pt``,
the trajectory's epoch -1), instead of from the earliest checkpoint: the
lite family's bar, since Lite-S is near its ceiling by the earliest
checkpoint (``--conf-file configs/yolov6_lite/yolov6_lite_s.py --gain-over
untrained``).

``--fuse-ab`` trains with the anchor-aided branch and its loss. ``--distill``
runs the N/S self-distillation recipe in two stages, as the JAX tool: the
config is written with DFL switched on (``use_dfl=True``, ``reg_max=16``)
for both; stage 1 trains a fuse-AB teacher for ``--teacher-epochs`` (0: as
many as ``--epochs``), stage 2 the distill-NS student against the teacher's
``best_ckpt.pt``; the student's checkpoints are evaluated with the original
config, the fold dropping the train-only DFL branch. ``--repopt`` runs the
RepOpt recipe in two stages, as the JAX tool: a hyper-search stage of
``--hs-conf-file`` (LinearAddBlocks) for ``--hs-epochs`` (0: max(6, epochs //
4)) writes its ``last_ckpt.pt``; an opt config, ``--opt-conf-file`` with its
``scales=`` pointing at that file, then trains the RealVGG graph with the
masked gradients, and its checkpoints are evaluated with that config.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import re
import sys
import time

REPO_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def get_args_parser(add_help=True):
    p = argparse.ArgumentParser("YOLOv6 synthetic learning gate (PyTorch port)",
                                add_help=add_help)
    p.add_argument("--out", type=str, required=True, help="work dir (dataset + runs)")
    p.add_argument("--conf-file", type=str, default=osp.join(REPO_ROOT, "configs", "yolov6n.py"))
    p.add_argument("--img-size", type=int, default=160)
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--n-val", type=int, default=64)
    p.add_argument("--nc", type=int, default=4)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--max-labels", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-map50", type=float, default=None,
                   help="final mAP50 must reach this (default 0.75 at >= 30 epochs, else 0.50)")
    p.add_argument("--min-gain", type=float, default=None,
                   help="final mAP50 must beat the gain's base (--gain-over) by this "
                        "(default 0.20 at >= 30 epochs, else 0.10)")
    p.add_argument("--gain-over", choices=("earliest", "untrained"), default="earliest",
                   help="the gain's base: the earliest evaluated checkpoint (the JAX tool's) "
                        "or the seed-initialised model before its first step")
    p.add_argument("--eval-points", type=int, default=3,
                   help="number of checkpoints (the final one included) to evaluate")
    p.add_argument("--skip-exact-nms", action="store_true",
                   help="skip the eval at the exact NMS protocol")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fuse-ab", action="store_true",
                   help="train with the anchor-based branch and its loss (anchor-aided "
                        "training)")
    p.add_argument("--distill", action="store_true",
                   help="stage 1 trains a fuse-AB teacher, stage 2 the distill-NS student "
                        "against it")
    p.add_argument("--teacher-epochs", type=int, default=0,
                   help="the distill teacher stage's epochs (0: as many as --epochs)")
    p.add_argument("--repopt", action="store_true",
                   help="stage 1 runs the CSLA hyper-search, stage 2 trains the RepOpt graph "
                        "from its scales with the masked gradients")
    p.add_argument("--hs-conf-file", type=str,
                   default=osp.join(REPO_ROOT, "configs", "repopt", "yolov6n_hs.py"))
    p.add_argument("--opt-conf-file", type=str,
                   default=osp.join(REPO_ROOT, "configs", "repopt", "yolov6n_opt.py"))
    p.add_argument("--hs-epochs", type=int, default=0,
                   help="the hyper-search stage's epochs (0: max(6, epochs // 4))")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; cuda raises when there is no GPU")
    return p


def resolve_thresholds(args):
    """The tiered bar (JAX: tools/learning_gate.py:91-100)."""
    if args.min_map50 is None:
        args.min_map50 = 0.75 if args.epochs >= 30 else 0.50
    if args.min_gain is None:
        args.min_gain = 0.20 if args.epochs >= 30 else 0.10
    return args


def _eval_ckpt(data, ckpt, conf_file, img_size, batch_size, save_dir, device, **eval_kw):
    from yolov6_tpu_torch.tools.eval import run

    (map50, map50_95), _ = run(
        data=data, weights=ckpt, config=conf_file, batch_size=batch_size, img_size=img_size,
        conf_thres=0.03, iou_thres=0.65, task="val", half=False, save_dir=save_dir,
        device=device, **eval_kw)
    return float(map50), float(map50_95)


def _train_argv(args, data, conf_file, epochs, out_dir, name, stop_aug: bool = True):
    """The train CLI's arguments of a gate stage; without ``stop_aug`` the
    strong augmentations stop at the train CLI's default epoch, as in the
    JAX tool's hyper-search stage."""
    return [
        "--data-path", data,
        "--conf-file", conf_file,
        "--img-size", str(args.img_size),
        "--img-floor", str(args.img_size),
        "--batch-size", str(args.batch_size),
        "--epochs", str(epochs),
        "--workers", str(args.workers),
        "--eval-final-only",
        "--heavy-eval-range", "0",
    ] + (["--stop_aug_last_n_epoch", str(max(2, epochs // 6))] if stop_aug else []) + [
        "--output-dir", osp.join(args.out, out_dir),
        "--name", name,
        "--max-labels", str(args.max_labels),
        "--seed", str(args.seed),
        "--log-interval", "20",
        "--device", args.device,
    ] + (["--bf16"] if args.bf16 else [])


def _write_dfl_config(args) -> str:
    """The config with DFL switched on, for both distill stages (JAX:
    tools/learning_gate.py:218-238): the reference's recipe opens
    ``use_dfl``/``reg_max=16`` in the N/S config before training the
    teacher and the student."""
    with open(args.conf_file) as f:
        src = f.read()
    if "use_dfl=False" not in src or "reg_max=0" not in src:
        raise ValueError(f"{args.conf_file}: --distill flips use_dfl=False and reg_max=0, "
                         "and the config has not both")
    dfl_conf = osp.join(args.out, "distill_conf.py")
    with open(dfl_conf, "w") as f:
        f.write(src.replace("use_dfl=False", "use_dfl=True").replace("reg_max=0", "reg_max=16"))
    return dfl_conf


def _distill_prestage(args, data, train_cli, conf_file, LOGGER):
    """Distill stage 1: the fuse-AB teacher (JAX: tools/learning_gate.py:
    144-180); returns its trainer and its ``best_ckpt.pt`` (``last_ckpt.pt``
    when no eval made a best one)."""
    t_epochs = args.teacher_epochs or args.epochs
    t_args = train_cli.get_args_parser().parse_args(
        _train_argv(args, data, conf_file, t_epochs, "train_teacher", "teacher") + ["--fuse_ab"])
    LOGGER.info(f"Distill stage 1/2: fuse-AB teacher for {t_epochs} epochs")
    trainer = train_cli.main(t_args)
    ckpt = osp.join(t_args.save_dir, "weights", "best_ckpt.pt")
    if not osp.exists(ckpt):
        ckpt = osp.join(t_args.save_dir, "weights", "last_ckpt.pt")
    if not osp.exists(ckpt):
        raise FileNotFoundError(f"the teacher stage wrote no checkpoint: {ckpt}")
    return trainer, ckpt


def _repopt_prestage(args, data, train_cli, LOGGER):
    """RepOpt stage 1 (JAX: tools/learning_gate.py:103-145): the CSLA
    hyper-search run, then an opt config whose ``scales=`` points at its
    ``last_ckpt.pt``; returns that config's path and the stage's trainer."""
    hs_epochs = args.hs_epochs or max(6, args.epochs // 4)
    hs_args = train_cli.get_args_parser().parse_args(
        _train_argv(args, data, args.hs_conf_file, hs_epochs, "train_hs", "hs", stop_aug=False))
    LOGGER.info(f"RepOpt stage 1/2: hyper-search for {hs_epochs} epochs")
    trainer = train_cli.main(hs_args)
    scales_ckpt = osp.join(hs_args.save_dir, "weights", "last_ckpt.pt")
    if not osp.exists(scales_ckpt):
        raise FileNotFoundError(f"the hyper-search stage wrote no checkpoint: {scales_ckpt}")
    with open(args.opt_conf_file) as f:
        src = f.read()
    src, n_sub = re.subn(r"scales\s*=\s*'[^']*'", f"scales={scales_ckpt!r}", src, count=1)
    if n_sub != 1:
        raise ValueError(f"no scales= line in {args.opt_conf_file}")
    gen_conf = osp.join(args.out, "repopt_opt_gate.py")
    with open(gen_conf, "w") as f:
        f.write(src)
    LOGGER.info(f"RepOpt stage 2/2 config written: {gen_conf}")
    return gen_conf, trainer


def main(args) -> int:
    if sum(map(bool, (args.fuse_ab, args.distill, args.repopt))) > 1:
        raise ValueError("--fuse-ab, --distill and --repopt are separate gate modes: pick one "
                         "(distill models turn off fuse_ab)")
    import torch

    from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
    from yolov6_tpu_torch.tools import train as train_cli
    from yolov6_tpu_torch.utils.checkpoint import cpu_copy
    from yolov6_tpu_torch.utils.events import LOGGER

    resolve_thresholds(args)
    t_start = time.perf_counter()
    os.makedirs(args.out, exist_ok=True)
    data_root = osp.join(args.out, "dataset")
    data = osp.join(data_root, "data.json")
    if not osp.exists(data):
        LOGGER.info(f"Generating the synthetic dataset under {data_root}")
        generate_synth_dataset(data_root, n_train=args.n_train, n_val=args.n_val,
                               img_size=args.img_size * 2, nc=args.nc, seed=args.seed)

    conf_file, extra, teacher, hs = args.conf_file, [], None, None
    if args.fuse_ab:
        extra.append("--fuse_ab")
    if args.repopt:
        t0 = time.perf_counter()
        conf_file, hs_trainer = _repopt_prestage(args, data, train_cli, LOGGER)
        hs = {"conf": conf_file, "train_s": time.perf_counter() - t0,
              "epoch_stats": hs_trainer.epoch_stats, "eval_stats": hs_trainer.eval_stats}
    if args.distill:
        conf_file = _write_dfl_config(args)
        t0 = time.perf_counter()
        t_trainer, teacher_ckpt = _distill_prestage(args, data, train_cli, conf_file, LOGGER)
        teacher = {"ckpt": teacher_ckpt, "train_s": time.perf_counter() - t0,
                   "eval_stats": t_trainer.eval_stats, "epoch_stats": t_trainer.epoch_stats}
        extra += ["--distill", "--teacher_model_path", teacher_ckpt]
    train_args = train_cli.get_args_parser().parse_args(
        _train_argv(args, data, conf_file, args.epochs, "train", "gate")
        + ["--save_ckpt_on_last_n_epoch", str(args.epochs)] + extra)  # every epoch
    t0 = time.perf_counter()
    trainer = train_cli.build_trainer(train_args)
    untrained = osp.join(train_args.save_dir, "weights", "untrained_ckpt.pt")
    if args.gain_over == "untrained":
        # the seed-initialised EMA equals the model before its first step
        os.makedirs(osp.dirname(untrained), exist_ok=True)
        torch.save({"ema": cpu_copy(trainer.train_step.ema.state_dict())}, untrained)
    train_cli.run(trainer)
    train_s = time.perf_counter() - t0
    weights_dir = osp.join(train_args.save_dir, "weights")

    # early / mid / final checkpoints (0-indexed "<e>_ckpt.pt"; the stripped
    # final is last_ckpt.pt), evaluated with the config they trained with,
    # but the distilled student with the original config: it ships its
    # plain ltrb branch, the fold dropping the DFL branch
    eval_conf = args.conf_file if args.distill else conf_file
    pts = sorted({max(0, round((i + 1) * (args.epochs - 1) / args.eval_points))
                  for i in range(args.eval_points)})
    trajectory = []
    if args.gain_over == "untrained":
        m50, m5095 = _eval_ckpt(data, untrained, eval_conf, args.img_size, args.batch_size,
                                osp.join(args.out, "eval_untrained"), args.device)
        trajectory.append({"epoch": -1, "map50": m50, "map50_95": m5095})
        LOGGER.info(f"gate eval before the first step: mAP50={m50:.4f} mAP50-95={m5095:.4f}")
    for e in pts:
        ckpt = osp.join(weights_dir, f"{e}_ckpt.pt")
        if not osp.exists(ckpt):
            ckpt = osp.join(weights_dir, "last_ckpt.pt")
        m50, m5095 = _eval_ckpt(data, ckpt, eval_conf, args.img_size, args.batch_size,
                                osp.join(args.out, f"eval_e{e}"), args.device)
        trajectory.append({"epoch": e, "map50": m50, "map50_95": m5095})
        LOGGER.info(f"gate eval epoch {e}: mAP50={m50:.4f} mAP50-95={m5095:.4f}")

    final = trajectory[-1]
    result = {
        "trajectory": trajectory,
        "final_map50": final["map50"],
        "final_map50_95": final["map50_95"],
        "gain": final["map50"] - trajectory[0]["map50"],
        "min_map50": args.min_map50,
        "min_gain": args.min_gain,
        "gain_over": args.gain_over,
        "train_s": train_s,
        "epoch_stats": trainer.epoch_stats,
        "mode": ("distill" if args.distill else "fuse_ab" if args.fuse_ab
                 else "repopt" if args.repopt else "standard"),
    }
    if hs is not None:
        evals = hs["eval_stats"]
        hs["final_map50"] = evals[-1]["ap50"] if evals else None
        result["hyper_search"] = hs
    if teacher is not None:
        evals = teacher["eval_stats"]
        teacher["final_map50"] = evals[-1]["ap50"] if evals else None
        result["teacher"] = teacher
    if not args.skip_exact_nms:
        ckpt = osp.join(weights_dir, f"{pts[-1]}_ckpt.pt")
        if not osp.exists(ckpt):
            ckpt = osp.join(weights_dir, "last_ckpt.pt")
        m50_exact, m5095_exact = _eval_ckpt(
            data, ckpt, eval_conf, args.img_size, args.batch_size,
            osp.join(args.out, "eval_exact"), args.device, max_nms=30000, row_select="topk")
        result["exact_nms"] = {"map50": m50_exact, "map50_95": m5095_exact}
        result["nms_delta_map50_95"] = final["map50_95"] - m5095_exact
        LOGGER.info(f"NMS default vs exact: mAP50-95 {final['map50_95']:.4f} vs "
                    f"{m5095_exact:.4f} (delta {result['nms_delta_map50_95']:+.4f})")

    passed = final["map50"] >= args.min_map50 and result["gain"] >= args.min_gain
    result["passed"] = bool(passed)
    result["wall_s"] = time.perf_counter() - t_start
    print(json.dumps(result))
    with open(osp.join(args.out, "gate_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    if not passed:
        LOGGER.error(f"LEARNING GATE FAILED: final mAP50 {final['map50']:.4f} (need >= "
                     f"{args.min_map50}), gain {result['gain']:.4f} (need >= {args.min_gain})")
        return 1
    LOGGER.info(f"LEARNING GATE PASSED: mAP50 {final['map50']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(get_args_parser().parse_args()))
