"""The COCO mAP reproduction gate (port of tools/repro_gate.py): evaluate
YOLOv6-N/S/M/L on COCO val2017 at the published 640 protocol
(``configs/experiment/eval_640_repro.py``'s per-model image size and
shrink) and hold each against its published mAP50:95 within ``--tol``:

    python -m yolov6_tpu_torch.tools.repro_gate --coco-root /data/coco \\
        --weights-dir ./weights

``--coco-root`` holds ``images/val2017`` (or ``val2017``) and
``annotations/instances_val2017.json``; ``--weights-dir`` holds the released
``yolov6{n,s,m,l}.pt`` (upstream YOLOv6 files, read by
``utils/upstream_ckpt.py``, or the port's own). Each model goes through the
read, the fold, the decode and the NMS of ``tools/eval.py::run`` at
conf 0.03 and IoU 0.65; without ``--skip-nms-delta`` a second eval under the
exact protocol (``max_nms=30000``, per-anchor top-k rows) reports the mAP
the default candidate cap costs (``nmsΔ``). ``--device`` defaults to ``cuda``
and raises without it.

It downloads nothing: a model whose ``<name>.pt`` is missing is reported
``SKIP (no weights)``, as the JAX gate reports it without egress, and a
``<name>.msgpack`` (a JAX native file) raises ``ValueError``. Exit code 0
when every evaluated model is within ``--tol``, 1 when one is not, 2 when
none was evaluated; ``--out-json`` writes the rows.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
import sys

from yolov6_tpu_torch.tools.eval import run as eval_run
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.events import load_yaml

LOGGER = logging.getLogger(__name__)
REPO_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

# published COCO val2017 mAP50:95 @640 (reference README.md:41-44)
TARGETS = {
    "yolov6n": 37.5,
    "yolov6s": 45.0,
    "yolov6m": 50.0,
    "yolov6l": 52.8,
}


def get_args_parser(add_help=True):
    p = argparse.ArgumentParser(description="YOLOv6 mAP repro gate (PyTorch port)",
                                add_help=add_help)
    p.add_argument("--coco-root", type=str, required=True,
                   help="COCO root containing images/val2017 and "
                        "annotations/instances_val2017.json")
    p.add_argument("--weights-dir", type=str, default="./weights",
                   help="directory holding yolov6{n,s,m,l}.pt (nothing is downloaded)")
    p.add_argument("--models", nargs="+", default=list(TARGETS),
                   choices=list(TARGETS), help="subset of models to gate")
    p.add_argument("--tol", type=float, default=0.2,
                   help="allowed |mAP - target| in mAP points")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--save-dir", type=str, default="runs/repro_gate")
    p.add_argument("--out-json", type=str, default=None,
                   help="write the per-model results to this JSON file")
    p.add_argument("--skip-nms-delta", action="store_true",
                   help="skip the second eval per model that measures the "
                        "capped-vs-exact NMS mAP delta")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; cuda raises when there is no GPU")
    return p


def build_coco_data_dict(coco_root: str) -> dict:
    """The data dict of a standard COCO layout (``data/coco.yaml``'s schema,
    read by the port's ``load_yaml``)."""
    val_images = osp.join(coco_root, "images", "val2017")
    if not osp.isdir(val_images):
        val_images = osp.join(coco_root, "val2017")  # flat layout
    anno = osp.join(coco_root, "annotations", "instances_val2017.json")
    if not osp.isdir(val_images) or not osp.exists(anno):
        raise FileNotFoundError(
            f"COCO val2017 not found under {coco_root} "
            f"(need images/val2017 + annotations/instances_val2017.json)"
        )
    base = load_yaml(osp.join(REPO_ROOT, "data", "coco.yaml"))
    base.update(val=val_images, anno_path=anno, is_coco=True)
    return base


def main(args) -> int:
    data = build_coco_data_dict(args.coco_root)
    repro = Config.fromfile(osp.join(REPO_ROOT, "configs", "experiment", "eval_640_repro.py"))

    rows, ok = [], True
    for name in args.models:
        weights = osp.join(args.weights_dir, f"{name}.pt")
        if not osp.exists(weights):
            native = osp.join(args.weights_dir, f"{name}.msgpack")
            if osp.exists(native):
                raise ValueError(f"{native}: a JAX native msgpack file, which the port does not "
                                 f"read; put the released {name}.pt (or the port's own "
                                 "checkpoint) in --weights-dir")
            rows.append((name, None, TARGETS[name], "SKIP (no weights)", None))
            continue
        ep = repro.eval_params.get(name, repro.eval_params["default"])
        save_dir = osp.join(args.save_dir, name)
        os.makedirs(save_dir, exist_ok=True)
        common = dict(
            weights=weights,
            config=osp.join(REPO_ROOT, "configs", f"{name}.py"),
            batch_size=args.batch_size,
            img_size=ep["img_size"],
            conf_thres=0.03,
            iou_thres=0.65,
            task="val",
            shrink_size=ep["shrink_size"],
            infer_on_rect=ep["infer_on_rect"],
            device=args.device,
        )
        LOGGER.info(f"=== {name}: eval @{ep['img_size']} shrink={ep['shrink_size']} ===")
        (map50, map5095), _ = eval_run(dict(data), save_dir=save_dir, **common)
        map_pts = 100.0 * float(map5095)
        delta = map_pts - TARGETS[name]
        status = "PASS" if abs(delta) <= args.tol else "FAIL"
        ok &= status == "PASS"

        # the same eval under the exact 30000-candidate protocol (per-anchor
        # exact top-k rows): the mAP the default cap of 8192 costs
        nms_delta = None
        if not args.skip_nms_delta:
            LOGGER.info(f"=== {name}: exact-NMS protocol eval (max_nms=30000) ===")
            (_, map5095_exact), _ = eval_run(
                dict(data), save_dir=osp.join(save_dir, "exact_nms"),
                max_nms=30000, row_select="topk", **common)
            nms_delta = map_pts - 100.0 * float(map5095_exact)
            status += f" nmsΔ={nms_delta:+.3f}"
        rows.append(
            (name, map_pts, TARGETS[name], f"{status} ({delta:+.2f})", nms_delta))

    print(f"\n{'model':10s} {'mAP50:95':>9s} {'target':>7s} {'nmsΔ':>7s}  status")
    for name, got, target, status, nms_delta in rows:
        got_s = f"{got:9.2f}" if got is not None else f"{'—':>9s}"
        nd_s = f"{nms_delta:+7.3f}" if nms_delta is not None else f"{'—':>7s}"
        print(f"{name:10s} {got_s} {target:7.1f} {nd_s}  {status}")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(
                [{"model": n, "map": g, "target": t, "status": s,
                  "nms_delta": d}
                 for n, g, t, s, d in rows], f, indent=2,
            )
    evaluated = [r for r in rows if r[1] is not None]
    if not evaluated:
        LOGGER.warning("no models evaluated (no weights) — gate inconclusive")
        return 2
    return 0 if ok else 1


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    sys.exit(main(get_args_parser().parse_args()))
