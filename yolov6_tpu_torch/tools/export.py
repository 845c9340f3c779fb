"""Export CLI (port of tools/export.py):

    python -m yolov6_tpu_torch.tools.export --weights <state dict>.pt \
        --config configs/yolov6s.py [--format pt2|onnx|torchscript|ncnn|openvino|tensorrt] \
        [--end2end] [--half] [--check] [--device cpu]

Formats:
- ``pt2`` (default; the JAX CLI's ``stablehlo``): the serve (preprocessing
  with ``--with-preprocess``, model, decode, and with ``--end2end`` the
  fixed-shape NMS through the registered keep op) as a ``torch.export``
  program (models/end2end.py). Without ``--end2end`` it returns the decoded
  ``[b, A, 5+nc]`` predictions. ``--half``: bf16 weights and activations,
  decode and NMS in fp32. ``--check`` loads it back with ``load_serving``
  and holds its outputs against the live function's.
- ``onnx``: the deploy model plus decode as an opset-13 graph over NHWC
  images (export/onnx_export.py); ``--end2end`` appends the ORT
  ``NonMaxSuppression`` tail, or with ``--trt-version 7|8`` the TensorRT
  plugin's; ``--half`` converts it to fp16, ``--dynamic-batch`` makes the
  batch dynamic, ``--quant`` writes INT8 QDQ from a PTQ or QAT checkpoint's
  ranges plus the plain graph and TRT calibration cache beside it.
  ``--check`` runs it through the numpy interpreter against the port.
- ``torchscript``: the deploy model plus decode traced (export/
  torch_export.py); ``--check`` loads it and compares.
- ``ncnn``: ``.param``/``.bin`` for the lite family (``--half`` stores fp16
  weights); ``--check`` runs the numpy executor against the head maps.
- ``openvino`` / ``tensorrt``: the ONNX file, then ``mo``/``ovc`` or
  ``trtexec``, which exit with the JAX CLI's message when absent.

Refused, with the reason: ``--platforms`` (a ``.pt2`` runs where it is
loaded), ``--weights-as-args`` (a TPU remote-compile size limit),
``--shard-devices`` other than 1 (GSPMD serving waits for the multi-card
work) and ``--runner-dir`` (the JAX package's native PJRT runner), all on
ROADMAP. ``--device`` defaults to ``cuda`` and raises without it; export on
the device that will serve.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os.path as osp
import shutil
import subprocess
import time

import numpy as np
import torch

from yolov6_tpu_torch.utils.checkpoint import load_state_dict_file
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.device import resolve_device
from yolov6_tpu_torch.utils.events import LOGGER

FORMATS = ("pt2", "onnx", "openvino", "tensorrt", "torchscript", "ncnn")


def _export_openvino(onnx_path: str, output_dir):
    """ONNX -> OpenVINO IR via the model-optimizer CLI (JAX:
    tools/export.py:_export_openvino; reference
    deploy/OpenVINO/export_openvino.py:23-94)."""
    mo = shutil.which("mo") or shutil.which("ovc")
    if mo is None:
        raise SystemExit(
            "OpenVINO model optimizer (`mo`/`ovc`) not found on PATH — "
            "install the openvino-dev package on the deploy host and re-run, "
            f"or consume the ONNX file already written to {onnx_path}"
        )
    out_dir = output_dir or (onnx_path.rsplit(".", 1)[0] + "_openvino")
    if osp.basename(mo) == "ovc":  # OpenVINO >= 2023 converter
        cmd = [mo, onnx_path, "--output_model",
               osp.join(out_dir, osp.basename(onnx_path).rsplit(".", 1)[0])]
    else:
        cmd = [mo, "--input_model", onnx_path, "--output_dir", out_dir]
    LOGGER.info(f"Running: {' '.join(cmd)}")
    res = subprocess.run(cmd)
    if res.returncode != 0:
        raise SystemExit(f"model optimizer failed with rc={res.returncode}")
    LOGGER.info(f"Exported OpenVINO IR to {out_dir}")


def _export_tensorrt(onnx_path: str, output, dtype: str):
    """ONNX -> TensorRT engine via ``trtexec`` (JAX:
    tools/export.py:_export_tensorrt; reference
    deploy/TensorRT/onnx_to_trt.py:59-127)."""
    trtexec = shutil.which("trtexec")
    if trtexec is None:
        raise SystemExit(
            "`trtexec` not found on PATH — install TensorRT on the deploy "
            "host (the engine must be built on the GPU that serves it) and "
            f"re-run, or consume the ONNX file already written to {onnx_path}"
        )
    engine = output or (onnx_path.rsplit(".", 1)[0] + ".trt")
    cmd = [trtexec, f"--onnx={onnx_path}", f"--saveEngine={engine}"]
    if dtype == "fp16":
        cmd.append("--fp16")
    elif dtype == "int8":
        cmd += ["--int8", "--fp16"]  # QDQ ranges drive int8; fp16 fallback
    LOGGER.info(f"Running: {' '.join(cmd)}")
    res = subprocess.run(cmd)
    if res.returncode != 0:
        raise SystemExit(f"trtexec failed with rc={res.returncode}")
    LOGGER.info(f"Built TensorRT engine {engine}")


def get_args_parser(add_help=True):
    p = argparse.ArgumentParser(description="YOLOv6 export (PyTorch port)", add_help=add_help)
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--img-size", nargs="+", type=int, default=[640, 640])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-classes", type=int, default=None,
                   help="checked against the weights' head (which decides it)")
    p.add_argument("--half", action="store_true",
                   help="pt2: bf16 weights and activations; onnx: fp16 file; ncnn: fp16 "
                        "weight storage")
    p.add_argument("--end2end", action="store_true", help="include NMS in the graph")
    p.add_argument("--trt-version", type=int, default=0, choices=(0, 7, 8),
                   help="onnx --end2end: the TensorRT NMS plugin's contract in place of "
                        "ORT NonMaxSuppression (8 EfficientNMS_TRT, 7 BatchedNMSDynamic_TRT)")
    p.add_argument("--with-preprocess", action="store_true",
                   help="fold BGR->RGB + /255 into the graph (uint8 input)")
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=100)
    p.add_argument("--platforms", nargs="+", default=None, help="refused (see the module doc)")
    p.add_argument("--weights-as-args", action="store_true", help="refused")
    p.add_argument("--shard-devices", type=int, default=1, help="refused unless 1")
    p.add_argument("--runner-dir", type=str, default=None, help="refused")
    p.add_argument("--engine-dtype", choices=("fp32", "fp16", "int8"), default="fp16",
                   help="--format tensorrt: engine precision")
    p.add_argument("--format", choices=FORMATS, default="pt2")
    p.add_argument("--quant", action="store_true",
                   help="onnx: INT8 QDQ from a PTQ/QAT checkpoint's ranges")
    p.add_argument("--num-bits", type=int, default=8)
    p.add_argument("--dynamic-batch", action="store_true", help="onnx: a dynamic batch")
    p.add_argument("--check", action="store_true", help="round-trip check")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; cuda raises when there is no GPU")
    return p


def _refuse(args):
    if args.platforms:
        raise SystemExit("--platforms: a .pt2 program runs on the device it is loaded onto "
                         "(load_serving(path, device)); the multi-platform StableHLO artifact "
                         "is on ROADMAP's do-not-port list")
    if args.weights_as_args:
        raise SystemExit("--weights-as-args exists for a TPU remote-compile size limit and is "
                         "on ROADMAP's do-not-port list; a .pt2 holds its weights")
    if args.shard_devices != 1:
        raise SystemExit("--shard-devices: multi-card GSPMD serving over a device mesh (the "
                         "GSPMD export) is on ROADMAP's do-not-port list")
    if args.runner_dir:
        raise SystemExit("--runner-dir feeds the JAX package's native PJRT runner, which is "
                         "on ROADMAP's do-not-port list")
    if args.format == "onnx" and args.half and (args.quant or args.end2end):
        raise SystemExit("--half (fp16 ONNX) is incompatible with --quant (int8 QDQ) and "
                         "--end2end (NonMaxSuppression requires fp32 inputs)")
    if args.format == "ncnn" and (args.end2end or args.dynamic_batch or args.quant):
        raise SystemExit("--format ncnn emits the raw-head lite graph consumed by the "
                         "reference's yolo.cpp (decode+NMS live in the app) — incompatible "
                         "with --end2end/--dynamic-batch/--quant")
    if args.format == "torchscript" and (args.end2end or args.dynamic_batch or args.half):
        raise SystemExit("--format torchscript exports the plain model+decode graph (the "
                         "reference TorchScript/NCNN contract) — incompatible with --end2end, "
                         "--dynamic-batch and --half")
    if args.dynamic_batch and args.end2end:
        raise SystemExit("--dynamic-batch is not supported with --end2end (the NMS tail "
                         "bakes per-batch constants)")
    if args.quant and args.format not in ("onnx", "tensorrt", "openvino"):
        raise SystemExit("--quant writes an INT8 QDQ ONNX file: use --format onnx")
    if args.dynamic_batch and args.format not in ("onnx", "tensorrt", "openvino"):
        raise SystemExit("--dynamic-batch applies to the ONNX formats")


def main(args):
    """Export; returns the path of the artifact written (the ONNX file for
    the vendor formats, whose tools write theirs beside it)."""
    _refuse(args)
    if len(args.img_size) == 1:
        args.img_size = args.img_size * 2
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    model = load_state_dict_file(args.weights, cfg, device=device)
    if args.num_classes is not None and args.num_classes != model.num_classes:
        raise SystemExit(f"--num-classes {args.num_classes}: the weights' head has "
                         f"{model.num_classes}")
    base = args.weights.rsplit(".", 1)[0]
    if args.format == "ncnn":
        return _ncnn(args, model, base)
    if args.format == "torchscript":
        return _torchscript(args, model, base, device)
    if args.format == "pt2":
        return _pt2(args, model, base, device)
    return _onnx(args, model, base, device)


def _pt2(args, model, base, device):
    from yolov6_tpu_torch.export.torch_export import DeployForward
    from yolov6_tpu_torch.models.end2end import (
        export_program, export_serve_module, load_serving, make_end2end_fn,
    )

    output = args.output or base + ".pt2"
    in_dtype = torch.uint8 if args.with_preprocess else torch.float32
    t0 = time.time()
    if args.end2end:
        module = export_serve_module(model, args.conf_thres, args.iou_thres, args.max_det,
                                     with_preprocess=args.with_preprocess, half=args.half)
    else:
        dtype = torch.bfloat16 if args.half else torch.float32
        module = DeployForward(copy.deepcopy(model).to(dtype) if args.half else model,
                               args.with_preprocess, dtype).eval()
    export_program(module, args.batch_size, tuple(args.img_size), output, input_dtype=in_dtype)
    LOGGER.info(f"Exported to {output} in {time.time() - t0:.1f}s")
    if args.check:
        art = load_serving(output, device)
        x = _check_input(args, in_dtype, device)
        got = art.call(x)
        if args.end2end:
            want = make_end2end_fn(model, args.conf_thres, args.iou_thres, args.max_det,
                                   with_preprocess=args.with_preprocess, half=args.half,
                                   device=device)(x)
            # the live serve's decode and NMS: fp32 (its bf16 model under autocast,
            # the graph's with bf16 weights): the detections agree within the
            # fp32 graph's or the decode's tolerances
            box_tol, score_tol = ((DECODE_BOX_TOL, DECODE_SCORE_TOL) if args.half else
                                  (dict(rtol=0.0, atol=1e-4 * max(args.img_size)),
                                   dict(rtol=0.0, atol=1e-4)))
            assert torch.equal(got[0], want[0]), "num_dets differ from the live serve"
            valid = torch.arange(args.max_det, device=got[0].device)[None] < want[0]
            assert torch.equal(got[3][valid], want[3][valid]), "classes differ from the live serve"
            torch.testing.assert_close(got[1][valid], want[1][valid], **box_tol)
            torch.testing.assert_close(got[2][valid], want[2][valid], **score_tol)
            LOGGER.info(f"Round-trip OK; outputs: {[tuple(o.shape) for o in got]}, "
                        f"num_dets={got[0].flatten().tolist()} (live "
                        f"{want[0].flatten().tolist()})")
        else:
            with torch.no_grad():
                want = module(x)
            assert torch.equal(got, want), "the loaded program differs from the module"
            LOGGER.info(f"Round-trip OK; output {tuple(got.shape)}")
    return output


# --check of an end2end .pt2 against the live serve: boxes (px) and scores
DECODE_BOX_TOL = dict(rtol=1e-4, atol=1e-2)
DECODE_SCORE_TOL = dict(rtol=0.0, atol=1e-4)


def _check_input(args, dtype, device):
    rng = np.random.default_rng(0)
    shape = (args.batch_size, *args.img_size, 3)
    x = rng.uniform(0, 255 if dtype == torch.uint8 else 1, shape)
    return torch.from_numpy(x.astype(np.uint8 if dtype == torch.uint8 else np.float32)).to(device)


def _onnx(args, model, base, device):
    from yolov6_tpu_torch.export.onnx_export import SENTINEL, export_onnx, make_dynamic_batch
    from yolov6_tpu_torch.export.onnx_numpy import OnnxRunner
    from yolov6_tpu_torch.export.onnx_proto import parse_model
    from yolov6_tpu_torch.export.onnx_quant import (
        encode_parsed, remove_qdq, save_calib_cache_file, to_fp16, to_qdq,
    )
    from yolov6_tpu_torch.export.torch_export import DeployForward
    from yolov6_tpu_torch.quant.state import quant_mode

    vendor = args.format in ("openvino", "tensorrt")
    output = base + ".onnx" if vendor else (args.output or base + ".onnx")
    in_dtype = torch.uint8 if args.with_preprocess else torch.float32
    fwd = DeployForward(model, args.with_preprocess).eval()
    batch = max(args.batch_size, 2) if args.dynamic_batch else args.batch_size
    example = torch.zeros((batch, *args.img_size, 3), dtype=in_dtype, device=device)
    nms = (dict(max_obj=args.max_det, iou_thres=args.iou_thres, score_thres=args.conf_thres,
                trt_version=args.trt_version or None) if args.end2end else None)
    chk = _check_input(args, in_dtype, device)
    if args.dynamic_batch:  # run the check at a batch the trace did not see
        chk = torch.cat([chk] * 3)[:3]
    ranges = getattr(model, "quant_ranges", None)
    if args.quant and not ranges:
        raise SystemExit("--quant needs a PTQ/QAT checkpoint carrying the 'quant' ranges "
                         "(produce one with tools/quantize.py)")
    t0 = time.time()
    with quant_mode(model, ranges if args.quant else None, num_bits=args.num_bits):
        data = export_onnx(fwd, (example,), input_names=["images"],
                           output_names=None if args.end2end else ["outputs"], nms=nms,
                           graph_name=osp.basename(args.config).rsplit(".", 1)[0],
                           doc=f"yolov6-tpu-torch export of {osp.basename(args.weights)}",
                           dynamic_batch=args.dynamic_batch)
        with torch.no_grad():
            want = None if args.end2end else fwd(chk).float().cpu().numpy()
    if args.quant:
        data = to_qdq(data, args.num_bits)
        plain, act_map = remove_qdq(data)
        qbase = output.rsplit(".", 1)[0]
        with open(qbase + "_remove_qdq.onnx", "wb") as f:
            f.write(plain)
        save_calib_cache_file(qbase + "_remove_qdq_calibration.cache", act_map)
        LOGGER.info(f"Wrote implicit-int8 companions: {qbase}_remove_qdq.onnx + calibration "
                    f"cache ({len(act_map)} activation scales)")
    if args.dynamic_batch or args.half:
        m = parse_model(data)
        if args.dynamic_batch:
            make_dynamic_batch(m, SENTINEL)
        if args.half:
            to_fp16(m)
        data = encode_parsed(m, opset=m.opset or 13)
    with open(output, "wb") as f:
        f.write(data)
    LOGGER.info(f"Exported ONNX to {output} in {time.time() - t0:.1f}s"
                + (f" (end2end, TRT{args.trt_version} NMS plugin)" if nms and args.trt_version
                   else " (end2end: in-graph NonMaxSuppression)" if nms else "")
                + (f" (INT8 QDQ, {args.num_bits}-bit)" if args.quant else ""))
    if args.check and args.end2end and args.trt_version:
        LOGGER.info("--check skipped: TRT plugin ops only execute inside TensorRT")
    elif args.check:
        x = chk.cpu().numpy()
        outs = OnnxRunner(data)(x.astype(np.float16) if args.half else x)
        if args.end2end:
            num_det, _, det_scores, _ = outs
            assert int(num_det.sum()) == int((det_scores > 0).sum())
            LOGGER.info(f"Round-trip OK (end2end): num_dets={num_det.ravel().tolist()}")
        else:
            # fp16 checks are loose: the numpy oracle accumulates in fp16
            atol, rtol = (0.5, 0.05) if args.half else (5e-4, 1e-4)
            np.testing.assert_allclose(outs[0].astype(np.float32), want, atol=atol, rtol=rtol)
            LOGGER.info(f"Round-trip OK (numpy interpreter matches the port); "
                        f"output {outs[0].shape}")
    if args.format == "openvino":
        _export_openvino(output, args.output)
    elif args.format == "tensorrt":
        _export_tensorrt(output, args.output, args.engine_dtype)
    return output


def _torchscript(args, model, base, device):
    from yolov6_tpu_torch.export.torch_export import DeployForward, export_torchscript

    output = args.output or base + ".torchscript.pt"
    x = _check_input(args, torch.float32, device)
    export_torchscript(model, (x,), output)
    LOGGER.info(f"Exported TorchScript to {output}")
    if args.check:
        loaded = torch.jit.load(output, map_location=device)
        with torch.no_grad():
            got, want = loaded(x), DeployForward(model)(x)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        LOGGER.info("Round-trip OK (TorchScript matches the port)")
    return output


def _ncnn(args, model, base):
    from yolov6_tpu_torch.export.ncnn_export import export_ncnn
    from yolov6_tpu_torch.export.ncnn_numpy import NcnnRunner

    prefix = args.output.rsplit(".", 1)[0] if args.output else base
    t0 = time.time()
    param_path, bin_path = export_ncnn(model, prefix, fp16=args.half)
    LOGGER.info(f"Exported NCNN to {param_path} + {bin_path} in {time.time() - t0:.1f}s"
                + (" (fp16 weights)" if args.half else ""))
    if args.check:
        img = np.random.default_rng(0).uniform(0, 1, (*args.img_size, 3)).astype(np.float32)
        blobs = NcnnRunner(param_path, bin_path)(img.transpose(2, 0, 1))
        device = next(model.parameters()).device
        with torch.no_grad():
            head, _ = model(torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).to(device))
        tol = 2e-2 if args.half else 2e-4
        for i, (cls, reg) in enumerate(zip(head["cls"], head["reg"])):
            want = torch.cat([torch.sigmoid(cls[0]), reg[0]], 0).cpu().numpy()
            np.testing.assert_allclose(blobs[f"out{i}"], want, rtol=tol, atol=tol)
        LOGGER.info("Round-trip OK (ncnn numpy executor == model)")
    return param_path


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main(get_args_parser().parse_args())
