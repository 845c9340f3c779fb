"""PTQ CLI (port of tools/quantize.py):

    python -m yolov6_tpu_torch.tools.quantize --weights <state dict>.pt \
        --config configs/repopt/yolov6s_opt_qat.py --data <set>/data.json [--eval]

Builds the config's deploy graph and loads ``--weights`` (the port's file or
an upstream ``.pt``, a train-form one folded), records each conv's input
range over ``--calib-batches`` batches of the data's train split (letterboxed,
no augmentation), fake-quantises the conv weights per channel but for
``--skip-layers`` (substrings of the JAX module path, e.g. ``detect/stems``)
and saves ``{"model": state dict + "quant": ranges, "quant_bits": n}`` to
``--output`` (default ``<weights>_ptq<n>.pt``). ``--eval`` then runs the
Evaler on the val split with the ranges enabled (``--skip-layers`` stay in
float). ``--device`` defaults to ``cuda`` and raises without it.
"""

from __future__ import annotations

import argparse
import logging
import os.path as osp

from yolov6_tpu_torch.core.evaler import Evaler
from yolov6_tpu_torch.data.data_load import create_dataloader
from yolov6_tpu_torch.quant.ptq import calibrate, quantize_variables
from yolov6_tpu_torch.quant.state import quant_mode
from yolov6_tpu_torch.utils.checkpoint import cpu_copy, load_state_dict_file, save_checkpoint
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.device import resolve_device
from yolov6_tpu_torch.utils.events import LOGGER, load_yaml


def get_args_parser(add_help=True):
    parser = argparse.ArgumentParser(description="YOLOv6 PTQ calibration (PyTorch port)",
                                     add_help=add_help)
    parser.add_argument("--weights", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--data", required=True)
    parser.add_argument("--img-size", type=int, default=640)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--calib-batches", type=int, default=32)
    parser.add_argument("--num-bits", type=int, default=8)
    parser.add_argument("--skip-layers", nargs="*", default=[],
                        help="path substrings to keep in fp (sensitive layers)")
    parser.add_argument("--output", default=None)
    parser.add_argument("--eval", action="store_true", help="run COCO eval after PTQ")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; cuda raises when there is no GPU")
    return parser


def main(args):
    """Calibrate, quantise, save, and with ``--eval`` evaluate; returns
    ``(output path, ranges, (AP50, AP) or None)``."""
    device = resolve_device(args.device)
    data_dict = load_yaml(args.data)
    model = load_state_dict_file(args.weights, Config.fromfile(args.config), device=device)
    loader, _ = create_dataloader(data_dict["train"], args.img_size, args.batch_size,
                                  data_dict=data_dict, task="train",
                                  pin_memory=device.type == "cuda")
    amax = calibrate(model, loader, num_bits=args.num_bits, skip_patterns=args.skip_layers,
                     max_batches=args.calib_batches)
    state = quantize_variables(model.state_dict(), model, args.num_bits, args.skip_layers)
    model.load_state_dict(state, strict=True)

    output = args.output or args.weights.rsplit(".", 1)[0] + f"_ptq{args.num_bits}.pt"
    path = save_checkpoint({"model": dict(cpu_copy(state), quant=cpu_copy(amax)),
                            "quant_bits": args.num_bits}, False, osp.dirname(output) or ".",
                           osp.splitext(osp.basename(output))[0])
    LOGGER.info(f"PTQ checkpoint saved to {path}")

    results = None
    if args.eval:
        evaler = Evaler(data_dict, batch_size=args.batch_size, img_size=args.img_size,
                        save_dir=osp.dirname(output) or ".", device=device)
        evaler.init_model(model)
        dataloader = evaler.init_data(None, "val")
        with quant_mode(model, amax, num_bits=args.num_bits, skip_patterns=args.skip_layers):
            preds = evaler.predict_model(model, dataloader, "val")
        results = tuple(float(v) for v in evaler.eval_model(preds, model, dataloader, "val")[:2])
        LOGGER.info(f"PTQ mAP@0.5: {results[0]:.5f}  mAP@0.5:0.95: {results[1]:.5f}")
    return path, amax, results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main(get_args_parser().parse_args())
