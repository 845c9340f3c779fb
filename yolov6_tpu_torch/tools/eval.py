"""Evaluation CLI (port of tools/eval.py:79-199):

    python -m yolov6_tpu_torch.tools.eval --data <set>/data.json \
        --config configs/yolov6s.py --weights <state dict>.pt

``--weights`` is a ``torch.save``d state dict (``utils/checkpoint.py``).
``run`` is also the in-training eval API. ``--device`` defaults to ``cuda``
and raises without it. ``--artifact <file>.pt2`` evaluates an end2end
serving artifact (``tools/export.py --end2end``, without
``--with-preprocess``, at ``--batch-size``) in place of ``--weights``: the
JAX CLI's StableHLO artifact eval. With ``--do_pr_metric`` the run's
directory gets ``PR_curve.png``, ``F1_curve.png``, ``P_curve.png`` and
``R_curve.png`` (``--plot_curve``, on unless given ``false``, ``0`` or
``no``) and with ``--plot_confusion_matrix`` ``confusion_matrix.png``. Not
ported: the TPU's ``--bf16-select`` and the weight download (a missing file
raises).
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp

from yolov6_tpu_torch.core.evaler import Evaler
from yolov6_tpu_torch.utils.checkpoint import load_state_dict_file
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.general import increment_name

LOGGER = logging.getLogger(__name__)
REPO_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def get_args_parser(add_help=True):
    parser = argparse.ArgumentParser(description="YOLOv6 COCO evaluation (PyTorch port)",
                                     add_help=add_help)
    parser.add_argument("--data", type=str, default="./data/coco.yaml",
                        help="dataset description, .json or flat .yaml")
    parser.add_argument("--weights", type=str, default="./weights/yolov6s.pt",
                        help="a torch.save'd state dict (bare, or under 'ema'/'model') or an "
                             "upstream YOLOv6 .pt")
    parser.add_argument("--config", type=str, default="./configs/yolov6s.py",
                        help="model config (needed to rebuild the graph)")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--img-size", type=int, default=640)
    parser.add_argument("--conf-thres", type=float, default=0.03)
    parser.add_argument("--iou-thres", type=float, default=0.65)
    parser.add_argument("--task", default="val", help="val, test or speed")
    parser.add_argument("--half", default=True, action="store_true", help="bf16 inference")
    parser.add_argument("--save_dir", type=str, default="runs/val/")
    parser.add_argument("--name", type=str, default="exp")
    parser.add_argument("--shrink_size", type=int, default=0)
    parser.add_argument("--infer_on_rect", default=False, action="store_true")
    parser.add_argument("--reproduce_640_eval", default=False, action="store_true")
    parser.add_argument("--eval_config_file", type=str,
                        default=osp.join(REPO_ROOT, "configs", "experiment", "eval_640_repro.py"))
    parser.add_argument("--verbose", default=False, action="store_true")
    parser.add_argument("--specific-shape", action="store_true")
    parser.add_argument("--height", type=int, default=640)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--config-file", default="", type=str,
                        help="experiment config whose eval_params override CLI args; lower "
                             "priority than --reproduce_640_eval (reference: tools/eval.py:52-67)")
    parser.add_argument("--max-nms", type=int, default=8192, help="NMS candidate cap")
    parser.add_argument("--row-select", choices=("grouped", "topk"), default="grouped",
                        help="per-anchor class pre-reduction of the NMS candidates")
    parser.add_argument("--do_pr_metric", action="store_true")
    parser.add_argument("--plot_curve", default=True,
                        type=lambda s: s.lower() not in ("false", "0", "no"),
                        help="save PR/F1/P/R curve PNGs with --do_pr_metric "
                             "(reference: tools/eval.py:42)")
    parser.add_argument("--plot_confusion_matrix", action="store_true")
    parser.add_argument("--artifact", type=str, default=None,
                        help="evaluate an end2end .pt2 serving artifact (tools/export.py "
                             "--end2end, no --with-preprocess) in place of --weights")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; cuda raises when there is no GPU")
    return parser


def run(
    data,
    weights=None,
    config=None,
    batch_size=32,
    img_size=640,
    conf_thres=0.03,
    iou_thres=0.65,
    task="val",
    half=True,
    model=None,
    dataloader=None,
    save_dir="",
    shrink_size=0,
    infer_on_rect=False,
    verbose=False,
    do_coco_metric=True,
    do_pr_metric=False,
    plot_curve=False,
    plot_confusion_matrix=False,
    specific_shape=False,
    height=640,
    width=640,
    max_nms=8192,
    row_select="grouped",
    device="cuda",
    artifact=None,
):
    """Evaluate a model (reference tools/eval.py:run, :88-159); returns
    ``((AP50, AP), COCO rows)``. ``model`` is a deploy model already on
    ``device``; without it the model is built from ``config`` and
    ``weights``, or with ``artifact`` an end2end ``.pt2`` is evaluated
    (``Evaler.init_artifact``)."""
    Evaler.check_task(task)
    if task != "train":
        os.makedirs(save_dir, exist_ok=True)
    Evaler.check_thres(conf_thres, iou_thres, task)
    if not isinstance(data, dict):
        data = Evaler.reload_dataset(data, task)

    evaler = Evaler(
        data, batch_size, img_size, conf_thres, iou_thres, half, save_dir,
        shrink_size, infer_on_rect, verbose, specific_shape, height, width,
        max_nms=max_nms, row_select=row_select, do_coco_metric=do_coco_metric,
        do_pr_metric=do_pr_metric, plot_curve=plot_curve,
        plot_confusion_matrix=plot_confusion_matrix, device=device,
    )
    if artifact:
        if task == "speed":
            raise ValueError("--task speed times a live model; an artifact's call is timed "
                             "by chip_smoke.py [33a]")
        model = evaler.init_artifact(artifact, num_classes=data["nc"])
    else:
        if model is None:
            model = load_state_dict_file(weights, Config.fromfile(config), device=evaler.device)
            if model.num_classes != data["nc"]:
                raise ValueError(f"{weights} predicts {model.num_classes} classes, "
                                 f"the dataset has nc={data['nc']}")
        evaler.init_model(model)
    if task == "speed":
        evaler.measure_speed(batch_size)
        return (0.0, 0.0), []
    dataloader = evaler.init_data(dataloader, task)
    pred_result = evaler.predict_model(model, dataloader, task)
    eval_result = evaler.eval_model(pred_result, model, dataloader, task)
    evaler.eval_speed(task)
    return eval_result, pred_result


def main(args):
    if args.config_file:
        # eval_params override CLI args; a list means [train_eval, standalone]
        # and the standalone slot (index 1) applies here (reference:
        # tools/eval.py:52-67 vs core/engine.py:237-242)
        if not os.path.exists(args.config_file):
            raise FileNotFoundError(f"config file {args.config_file} not found")
        cfg = Config.fromfile(args.config_file)
        for key, value in (cfg.get("eval_params") or {}).items():
            if key not in args.__dict__:
                LOGGER.info(f"Unrecognized config {key}, continue")
                continue
            if isinstance(value, list):
                if value[1] is not None:
                    args.__dict__[key] = value[1]
            elif value is not None:
                args.__dict__[key] = value
    if args.reproduce_640_eval:
        cfg = Config.fromfile(args.eval_config_file)
        model_key = osp.splitext(osp.basename(args.config))[0]
        eval_params = cfg.eval_params.get(model_key, cfg.eval_params["default"])
        args.shrink_size = eval_params.get("shrink_size", args.shrink_size)
        args.infer_on_rect = eval_params.get("infer_on_rect", args.infer_on_rect)
        args.img_size = eval_params.get("img_size", args.img_size)
        # forced repro params (reference: tools/eval.py:78-82)
        args.conf_thres = 0.03
        args.iou_thres = 0.65
        args.task = "val"
    save_dir = str(increment_name(osp.join(args.save_dir, args.name)))
    os.makedirs(save_dir, exist_ok=True)
    (ap50, ap), _ = run(
        args.data, args.weights, args.config, args.batch_size, args.img_size,
        args.conf_thres, args.iou_thres, args.task, args.half,
        save_dir=save_dir, shrink_size=args.shrink_size,
        infer_on_rect=args.infer_on_rect, verbose=args.verbose,
        do_pr_metric=args.do_pr_metric, plot_curve=args.plot_curve,
        plot_confusion_matrix=args.plot_confusion_matrix, specific_shape=args.specific_shape,
        height=args.height, width=args.width, max_nms=args.max_nms,
        row_select=args.row_select, device=args.device, artifact=args.artifact,
    )
    if args.task != "speed":
        LOGGER.info(f"mAP@0.5: {ap50:.5f}  mAP@0.5:0.95: {ap:.5f}  (results in {save_dir})")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main(get_args_parser().parse_args())
