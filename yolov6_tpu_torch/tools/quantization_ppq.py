"""PPQ-style ONNX-level PTQ program entrance (port of
tools/quantization_ppq.py, over yolov6_tpu_torch/quant/onnx_ptq.py;
calibration images are read by data/image_io.py and letterboxed by the
port, not cv2).

Reference analog: tools/quantization/ppq/ProgramEntrance.py:33-189 (load
ONNX -> minmax runtime calibration over a dataset -> TRT_INT8 QDQ export +
Quantized.json qparams) and write_qparams_onnx2trt.py (set TRT dynamic
ranges from the JSON, build an int8 engine). PPQ itself is not installable
here; the same pipeline runs natively on the port's ONNX stack — numpy
only, no GPU or ppq needed for the calibrate+export steps.

Usage:
    python -m yolov6_tpu_torch.tools.quantization_ppq --onnx yolov6s.onnx \
        --calib-dir /data/calib_imgs --img-size 640 --calib-steps 32 \
        --output Quantized.onnx --qparams Quantized.json
    # then on a TRT machine (or with --build-engine here if TRT exists):
    python -m yolov6_tpu_torch.tools.quantization_ppq --onnx yolov6s.onnx \
        --qparams Quantized.json --build-engine yolov6s_int8.engine
"""

from __future__ import annotations

import argparse
import glob
import logging
import os.path as osp
import sys

import numpy as np

from yolov6_tpu_torch.utils.events import LOGGER


def get_args_parser(add_help=True):
    p = argparse.ArgumentParser("ppq-style ONNX PTQ", add_help=add_help)
    p.add_argument("--onnx", type=str, required=True, help="exported fp32 ONNX")
    p.add_argument("--calib-dir", type=str, default=None,
                   help="directory of calibration images (jpg/png); random "
                        "data is used when absent, as in the reference "
                        "example — use real data for a deployable model")
    p.add_argument("--img-size", type=int, nargs="+", default=[640])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--calib-steps", type=int, default=32)
    p.add_argument("--num-bits", type=int, default=8)
    p.add_argument("--output", type=str, default="Quantized.onnx")
    p.add_argument("--qparams", type=str, default="Quantized.json")
    p.add_argument("--build-engine", type=str, default=None,
                   help="also build a TRT int8 engine to this path "
                        "(requires tensorrt; reference "
                        "write_qparams_onnx2trt.py)")
    p.add_argument("--skip-quantize", action="store_true",
                   help="only calibrate + write qparams (implicit-int8 flow)")
    return p


def _calib_batches(args, input_shape):
    """Yield calibration batches shaped like the graph input (NHWC)."""
    b, h, w = args.batch_size, input_shape[1], input_shape[2]
    if args.calib_dir:
        from yolov6_tpu_torch.data.data_augment import letterbox
        from yolov6_tpu_torch.data.image_io import imread

        paths = sorted(
            glob.glob(osp.join(args.calib_dir, "*.jpg"))
            + glob.glob(osp.join(args.calib_dir, "*.png"))
        )
        if not paths:
            raise SystemExit(f"no images under {args.calib_dir}")
        requested = args.calib_steps * b
        n_real = 0
        batch = []
        for path in paths:
            try:
                img = imread(path)
            except ValueError:  # a kind of image the port does not decode
                continue
            img = letterbox(img, (h, w), auto=False)[0]
            batch.append(img[:, :, ::-1].astype(np.float32) / 255.0)
            n_real += 1
            if len(batch) == b:
                yield np.stack(batch)
                batch = []
        if batch:
            # pad the tail batch by repeating the last image; make silent
            # under-coverage visible (a near-empty calib-dir would otherwise
            # let the duplicated tail dominate the calibration statistics)
            yield np.stack(batch + [batch[-1]] * (b - len(batch)))
        if n_real < requested:
            LOGGER.warning(
                f"calibration saw only {n_real} real images "
                f"(requested calib_steps*batch = {requested}); "
                f"{'tail batch padded by repetition — ' if batch else ''}"
                "ranges may under-cover the data distribution")
    else:
        LOGGER.warning("no --calib-dir: calibrating on RANDOM data (layout "
                       "check only, like the reference example's torch.rand)")
        rng = np.random.default_rng(0)
        while True:
            yield rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)


def main(args):
    from yolov6_tpu_torch.export.onnx_proto import parse_model
    from yolov6_tpu_torch.quant.onnx_ptq import (
        build_trt_engine_with_qparams,
        calibrate_onnx,
        insert_activation_qdq,
        write_qparams_json,
    )

    if len(args.img_size) == 1:
        args.img_size = args.img_size * 2

    with open(args.onnx, "rb") as f:
        model_bytes = f.read()

    if args.build_engine and osp.exists(args.qparams) and args.skip_quantize:
        LOGGER.info(build_trt_engine_with_qparams(
            args.onnx, args.qparams, args.build_engine))
        return 0

    m = parse_model(model_bytes)
    in_shape = list(m.inputs[0][2])
    for i, s in enumerate(in_shape):  # dynamic dims -> concrete calib shape
        if not isinstance(s, int) or s <= 0:
            in_shape[i] = (args.batch_size, *args.img_size, 3)[i]

    LOGGER.info(f"Calibrating {args.onnx} over {args.calib_steps} steps "
                f"(input {in_shape})")
    done = [0]

    def progress(step):
        done[0] = step + 1
        if (step + 1) % 8 == 0:
            LOGGER.info(f"  calib step {step + 1}/{args.calib_steps}")

    amax = calibrate_onnx(
        model_bytes, _calib_batches(args, in_shape),
        max_steps=args.calib_steps, progress=progress)
    write_qparams_json(args.qparams, amax)
    LOGGER.info(f"Wrote {len(amax)} activation ranges to {args.qparams} "
                f"({done[0]} calib steps)")

    if not args.skip_quantize:
        data = insert_activation_qdq(model_bytes, amax, args.num_bits)
        with open(args.output, "wb") as f:
            f.write(data)
        LOGGER.info(f"Wrote explicit-QDQ int8 model to {args.output} "
                    f"({len(data)} bytes vs fp32 {len(model_bytes)})")

    if args.build_engine:
        LOGGER.info(build_trt_engine_with_qparams(
            args.onnx, args.qparams, args.build_engine))
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    sys.exit(main(get_args_parser().parse_args()))
