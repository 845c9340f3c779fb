"""COCO evaluation (port of yolov6_tpu/core/evaler.py:29-552).

Each batch runs as one function on the device: uint8 NHWC images in, the
forward (bf16 autocast when ``half``), the decode and the fixed-shape NMS
(``ops/nms.py``, multi-label, the default keep: the CUDA kernel on the card).
The host turns its ``[b, max_det, 6]`` detections into COCO rows in
original-image pixels and scores them with ``utils/coco_eval.py``.

``predict_model`` keeps the JAX loop's one-batch software pipeline: batch
i+1's copy to the device and its launches are queued before batch i's
results are read on the host. It records, per batch, the time blocked on
the loader, the host's time to queue the batch function, the host
conversion and, on the card, the copy by CUDA events; these overlap, so
their sum is not the loop's wall time. The device's own time is not among
them: the batch function's launches reach the card as fast as the host
queues them, so events around it read the host's queueing.

``init_artifact`` evaluates an end2end ``.pt2`` serving artifact
(models/end2end.py) in place of a live model, on one device: the JAX
package's StableHLO artifact eval (its GSPMD form is not ported).

Across ranks (``parallel/dist.py``) each rank's Evaler predicts its shard of
the val set on its own device, and ``gather_coco_predictions`` gathers the
rows for rank 0 to score (the trainer's in-training eval). Not ported: the
TPU's bf16 candidate ranking.

With ``do_pr_metric``, ``plot_curve`` writes ``PR_curve.png``,
``F1_curve.png``, ``P_curve.png`` and ``R_curve.png`` and
``plot_confusion_matrix`` ``confusion_matrix.png`` into ``save_dir``
(utils/metrics.py, drawn by utils/plots.py), only when ``save_dir`` is set:
the trainer's eval sets it on rank 0 alone. ``plot_s`` holds the host
seconds of ``ap_per_class`` with its curves and of the matrix plot.
"""

from __future__ import annotations

import json
import logging
import os.path as osp
import time
from pathlib import Path

import numpy as np
import torch

from yolov6_tpu_torch.data.data_load import create_dataloader
from yolov6_tpu_torch.ops.nms import non_max_suppression
from yolov6_tpu_torch.parallel.dist import all_gather_rows, world_size
from yolov6_tpu_torch.utils.coco_eval import COCOEvaluator, coco80_to_coco91_class
from yolov6_tpu_torch.utils.data_config import load_data_config
from yolov6_tpu_torch.utils.device import resolve_device
from yolov6_tpu_torch.utils.metrics import ConfusionMatrix, ap_per_class, process_batch

LOGGER = logging.getLogger(__name__)


class Evaler:
    def __init__(
        self,
        data_dict: dict,
        batch_size: int = 32,
        img_size: int = 640,
        conf_thres: float = 0.03,
        iou_thres: float = 0.65,
        half: bool = True,
        save_dir: str = "",
        shrink_size: int = 0,
        infer_on_rect: bool = False,
        verbose: bool = False,
        specific_shape: bool = False,
        height: int = 640,
        width: int = 640,
        max_det: int = 300,
        max_nms: int = 8192,
        row_select: str = "grouped",
        do_coco_metric: bool = True,
        do_pr_metric: bool = False,
        plot_curve: bool = False,
        plot_confusion_matrix: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.data = data_dict
        self.batch_size = batch_size
        self.img_size = img_size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.half = half
        self.save_dir = save_dir
        self.shrink_size = shrink_size
        self.infer_on_rect = infer_on_rect
        self.verbose = verbose
        self.specific_shape = specific_shape
        self.height = height
        self.width = width
        self.max_det = max_det
        # the NMS candidate cap; the reference's is 30000 (utils/nms.py:55),
        # the JAX package's default 8192 (docs/nms_fidelity.md)
        self.max_nms = max_nms
        self.row_select = row_select
        self.is_coco = data_dict.get("is_coco", False)
        self.ids = coco80_to_coco91_class() if self.is_coco else list(range(1000))
        self.class_names = tuple(data_dict.get("names", ()) or ())
        self.speed_result = np.zeros(4)
        self.do_coco_metric = do_coco_metric
        self.do_pr_metric = do_pr_metric
        self.plot_curve = plot_curve
        self.plot_confusion_matrix = plot_confusion_matrix
        self.pr_results = None
        self.plot_s = {}
        # per batch of the last predict_model: loader_s, launch_s (the host's
        # time to queue the batch function), convert_s, and on the card h2d_ms
        # (CUDA events around the copy)
        self.batch_split = []

    # ------------------------------------------------------------ model/data

    def _preprocess(self, imgs_u8):
        """uint8 NHWC on the device -> NCHW in [0, 1], bf16 when ``half``."""
        dtype = torch.bfloat16 if self.half else torch.float32
        return imgs_u8.permute(0, 3, 1, 2).to(dtype).contiguous() / 255.0

    def init_model(self, model):
        """Build the per-batch functions over ``model``, which must already
        sit on the Evaler's device: ``_infer(imgs)`` (forward, decode, NMS)
        and ``_forward_only(imgs)`` (the forward's head maps)."""
        model_device = next(model.parameters()).device
        if model_device.type != self.device.type:
            raise ValueError(f"model is on {model_device}, the Evaler's device is {self.device}")
        model.eval()

        def _forward(imgs_u8):
            with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.half):
                return model(self._preprocess(imgs_u8))

        @torch.inference_mode()
        def _decode(imgs_u8):
            head_out, _ = _forward(imgs_u8)
            return model.decode(head_out)

        @torch.inference_mode()
        def _infer(imgs_u8):
            return non_max_suppression(
                _decode(imgs_u8), self.conf_thres, self.iou_thres, max_det=self.max_det,
                max_nms=self.max_nms, multi_label=True, row_select=self.row_select,
            )

        self._infer = _infer
        self._decode = _decode
        self._forward_only = torch.inference_mode()(_forward)
        self.model = model
        return model

    def init_artifact(self, path: str, num_classes: int = 80):
        """Evaluate an end2end ``.pt2`` artifact (``tools/export.py``, format
        ``pt2`` with ``--end2end``) instead of a live model, on the Evaler's
        device (JAX: evaler.py:146-211, the analog of the reference's
        TensorRT-engine eval). It must take float RGB images (exported
        without ``--with-preprocess``) at the Evaler's batch size; its own
        thresholds, rule and candidate cap do the NMS, so export it at the
        eval protocol to score it as the live model is scored. Returns a
        stand-in model carrying ``num_classes``."""
        from yolov6_tpu_torch.models.end2end import load_serving

        art = load_serving(path, self.device)
        (shape, dtype), = art.in_specs
        if not dtype.is_floating_point:
            raise ValueError(f"{path} takes {dtype} images: export it without "
                             "--with-preprocess (the Evaler feeds float RGB in [0, 1])")
        if shape[0] != self.batch_size:
            raise ValueError(f"{path} was exported at batch {shape[0]}, the Evaler's is "
                             f"{self.batch_size}")

        @torch.inference_mode()
        def _infer(imgs_u8):
            num_dets, boxes, scores, classes = art.call(imgs_u8.to(dtype) / 255.0)
            dets = torch.cat([boxes, scores[..., None], classes[..., None].float()], -1)
            valid = torch.arange(dets.shape[1], device=dets.device)[None] < num_dets
            return dets, valid

        self._infer = _infer
        self.artifact = art

        class _Shim:
            pass

        shim = _Shim()
        shim.num_classes = num_classes
        self.model = shim
        return shim

    def _to_device(self, imgs):
        """A host batch (numpy, or a pinned tensor) -> uint8 NHWC on the device,
        copied without blocking the host."""
        t = imgs if torch.is_tensor(imgs) else torch.from_numpy(np.ascontiguousarray(imgs))
        return t.to(self.device, non_blocking=True)

    def _to_host(self, t):
        """Queue the copy of ``t`` to the host (pinned memory, non-blocking on
        the card); read it after the batch's event."""
        if self.device.type != "cuda":
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    def init_data(self, dataloader=None, task: str = "val"):
        if task != "train" and dataloader is None:
            pad = 0.5 if self.infer_on_rect else 0.0
            eval_hyp = {"shrink_size": self.shrink_size} if self.shrink_size else {}
            dataloader, _ = create_dataloader(
                self.data[task if task in self.data else "val"],
                self.img_size,
                self.batch_size,
                hyp=eval_hyp,
                rect=self.infer_on_rect,
                pad=pad,
                data_dict=self.data,
                task=task,
                specific_shape=self.specific_shape,
                height=self.height,
                width=self.width,
                pin_memory=self.device.type == "cuda",
            )
        return dataloader

    # --------------------------------------------------------------- predict

    def predict_model(self, model, dataloader, task: str = "val"):
        """Run inference over the loader; returns COCO-format detections
        (reference: evaler.py:100-228)."""
        self.speed_result = np.zeros(4)
        self.batch_split = []
        pred_results = []
        stats = []
        iouv = np.linspace(0.5, 0.95, 10)
        confusion = None
        if self.do_pr_metric and self.plot_confusion_matrix:
            confusion = ConfusionMatrix(nc=model.num_classes)
        cuda = self.device.type == "cuda"
        n_batches = len(dataloader)

        def drain(p):
            """Wait for one in-flight batch and post-process it on the host."""
            dets, valid, events, paths, shapes, labels, hw, n_valid, rec = p
            if cuda:
                events[-1].synchronize()
                rec["h2d_ms"] = events[0].elapsed_time(events[1])
            dets, valid = dets.numpy(), valid.numpy()
            t0 = time.perf_counter()
            pred_results.extend(
                self.convert_to_coco_format(dets[:n_valid], valid[:n_valid], paths, shapes))
            rec["convert_s"] = time.perf_counter() - t0
            if self.do_pr_metric:
                stats.extend(self._pr_stats(dets, valid, labels, hw, n_valid, iouv, confusion))

        # one-batch software pipeline: batch i+1's copy and launches are
        # queued before batch i's results are read, so the copy, the device
        # work and the host's post-processing overlap (the reference's loop
        # is synchronous per batch, evaler.py:100-137)
        t_loop = time.perf_counter()
        pending = None
        batches = iter(dataloader)
        bi = 0
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            rec = {"loader_s": time.perf_counter() - t0, "h2d_ms": None}
            self.batch_split.append(rec)
            imgs, labels, paths, shapes, n_valid = batch
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else []
            if cuda:
                events[0].record()
            imgs_dev = self._to_device(imgs)
            if cuda:
                events[1].record()
            t0 = time.perf_counter()
            dets_dev, valid_dev = self._infer(imgs_dev)
            rec["launch_s"] = time.perf_counter() - t0
            dets, valid = self._to_host(dets_dev), self._to_host(valid_dev)
            if cuda:
                events.append(torch.cuda.Event())
                events[-1].record()
            self.speed_result[0] += n_valid
            if pending is not None:
                drain(pending)
            pending = (dets, valid, events, paths, shapes, labels, tuple(imgs.shape[1:3]),
                       n_valid, rec)
            if bi % 20 == 0:
                LOGGER.info(f"eval batch {bi + 1}/{n_batches}")
            bi += 1
        if pending is not None:
            drain(pending)
        # the wall time of the overlapped loop (per-batch times overlap)
        self.speed_result[2] += time.perf_counter() - t_loop

        if self.do_pr_metric and stats:
            self._finish_pr_metric(stats)
        if confusion is not None and self.save_dir:
            t0 = time.perf_counter()
            confusion.plot(save_dir=self.save_dir, names=self.class_names)
            self.plot_s["confusion_matrix"] = time.perf_counter() - t0
            LOGGER.info(f"Saved confusion matrix plot to {self.save_dir}")
        return pred_results

    def _pr_stats(self, dets, valid, labels, hw, n_valid, iouv, confusion=None):
        """Per-image TP stats in letterbox coords (reference: evaler.py:137-227)."""
        h, w = hw
        out = []
        for i in range(n_valid):
            pred = dets[i][valid[i]]
            lb = labels[i]
            lb = lb[lb[:, 0] >= 0]
            gt = np.zeros((len(lb), 5), np.float32)
            if len(lb):
                gt[:, 0] = lb[:, 0]
                cx, cy, bw, bh = lb[:, 1] * w, lb[:, 2] * h, lb[:, 3] * w, lb[:, 4] * h
                gt[:, 1], gt[:, 2] = cx - bw / 2, cy - bh / 2
                gt[:, 3], gt[:, 4] = cx + bw / 2, cy + bh / 2
            correct = process_batch(pred, gt, iouv)
            if confusion is not None:
                confusion.process_batch(pred, gt)
            out.append((correct, pred[:, 4], pred[:, 5], gt[:, 0]))
        return out

    def _finish_pr_metric(self, stats):
        tp = np.concatenate([s[0] for s in stats])
        conf = np.concatenate([s[1] for s in stats])
        pred_cls = np.concatenate([s[2] for s in stats])
        target_cls = np.concatenate([s[3] for s in stats])
        if tp.size == 0:
            self.pr_results = None
            return
        t0 = time.perf_counter()
        p, r, ap, f1, classes = ap_per_class(
            tp, conf, pred_cls, target_cls, plot=self.plot_curve and bool(self.save_dir),
            save_dir=self.save_dir or ".", names=self.class_names)
        self.plot_s["ap_per_class"] = time.perf_counter() - t0
        ap50, ap_all = ap[:, 0].mean(), ap.mean()
        LOGGER.info(
            f"PR metric: P={p.mean():.4f} R={r.mean():.4f} F1={f1.mean():.4f} "
            f"mAP@0.5={ap50:.4f} mAP@0.5:0.95={ap_all:.4f}"
        )
        self.pr_results = (float(ap50), float(ap_all))

    @staticmethod
    def scale_coords(coords, img0_shape, ratio_pad):
        """Letterbox pixels -> original-image pixels (reference: evaler.py:340-359)."""
        gain, pad = ratio_pad
        coords = coords.copy()
        coords[:, [0, 2]] = (coords[:, [0, 2]] - pad[0]) / gain[1]
        coords[:, [1, 3]] = (coords[:, [1, 3]] - pad[1]) / gain[0]
        coords[:, [0, 2]] = coords[:, [0, 2]].clip(0, img0_shape[1])
        coords[:, [1, 3]] = coords[:, [1, 3]].clip(0, img0_shape[0])
        return coords

    def convert_to_coco_format(self, dets, valid, paths, shapes):
        """(reference: evaler.py:361-384)"""
        results = []
        for i in range(len(dets)):
            keep = valid[i]
            if not keep.any():
                continue
            pred = dets[i][keep]
            path = Path(paths[i])
            shape0, ratio_pad = shapes[i]
            boxes = self.scale_coords(pred[:, :4], shape0, ratio_pad)
            # the dataset GT's convention: numeric stems become int ids
            image_id = int(path.stem) if path.stem.isnumeric() else path.stem
            wh = boxes[:, 2:4] - boxes[:, 0:2]  # xyxy -> top-left xywh
            xy = boxes[:, 0:2]
            for j in range(pred.shape[0]):
                results.append(
                    {
                        "image_id": image_id,
                        "category_id": self.ids[int(pred[j, 5])],
                        "bbox": [round(float(v), 3) for v in np.concatenate([xy[j], wh[j]])],
                        "score": round(float(pred[j, 4]), 5),
                    }
                )
        return results

    # ----------------------------------------------------------------- eval

    def eval_model(self, pred_results, model, dataloader, task: str = "val"):
        """COCO mAP by the port's evaluator (reference: evaler.py:231-321);
        returns ``(AP50, AP)``."""
        if not self.do_coco_metric:
            return self.pr_results or (0.0, 0.0)
        LOGGER.info("Evaluating mAP by the COCO-protocol evaluator...")
        anno_path = self.data.get(
            "anno_path",
            osp.join(self.data.get("path", "."), "annotations", "instances_val2017.json"),
        )
        if self.save_dir:
            with open(osp.join(self.save_dir, "predictions.json"), "w") as f:
                json.dump(pred_results, f)
        if not pred_results:
            LOGGER.warning("no detections produced; mAP = 0")
            return (0.0, 0.0)
        with open(anno_path) as f:
            gt = json.load(f)
        if self.is_coco:
            # restrict GT to evaluated images (subset evals)
            eval_ids = {d["image_id"] for d in pred_results}
            gt = dict(gt)
            gt["images"] = [im for im in gt["images"] if im["id"] in eval_ids]
            gt["annotations"] = [a for a in gt["annotations"] if a["image_id"] in eval_ids]
        evaluator = COCOEvaluator(gt)
        stats = evaluator.evaluate(pred_results, verbose=True)
        if self.verbose:
            names = {c["id"]: c.get("name", str(c["id"])) for c in gt["categories"]}
            LOGGER.info(f"{'class':<22}{'AP@0.5:0.95':>12}{'AP@0.5':>10}")
            for name, ap, ap50 in evaluator.per_class_ap(names):
                LOGGER.info(f"{name:<22}{ap:>12.4f}{ap50:>10.4f}")
        return (stats["AP50"], stats["AP"])

    def eval_speed(self, task: str = "speed"):
        """Log the per-image wall time of the pipelined loop (reference:
        evaler.py:323-329)."""
        if task != "train":
            n = max(1, self.speed_result[0])
            wall_time = 1000 * self.speed_result[2] / n
            LOGGER.info(
                "Average pipelined eval wall time (loader, copy, fwd+decode+NMS and host "
                f"conversion, overlapped): {wall_time:.2f} ms/img; --task speed "
                "(measure_speed) gives the device's own time"
            )

    def measure_speed(self, batch_size: int = 32, iters: int = 20):
        """ms per image of fwd+decode and of fwd+decode+NMS over ``iters``
        calls on random uint8 images (the reference's pre/infer/NMS split,
        evaler.py:118-135, for a function that runs in one piece): CUDA events
        on the card, ``time.perf_counter`` on the CPU."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        x = torch.randint(0, 256, (batch_size, self.img_size, self.img_size, 3),
                          dtype=torch.uint8, device=self.device, generator=gen)

        def timed(fn):
            for _ in range(2):
                fn(x)
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(self.device)
                start.record()
                for _ in range(iters):
                    fn(x)
                end.record()
                end.synchronize()
                total_ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(x)
                total_ms = (time.perf_counter() - t0) * 1e3
            return total_ms / iters / batch_size

        t_fwd = timed(self._decode)
        t_all = timed(self._infer)
        LOGGER.info(
            f"speed @b{batch_size}: fwd+decode {t_fwd:.3f} ms/img "
            f"({1000 / t_fwd:.0f} imgs/s), NMS {t_all - t_fwd:.3f} ms/img, "
            f"total {t_all:.3f} ms/img ({1000 / t_all:.0f} imgs/s) on {self.device}"
        )
        if self.save_dir:
            path = osp.join(self.save_dir, "speed.csv")
            write_header = not osp.exists(path)
            with open(path, "a") as f:
                if write_header:
                    f.write("batch_size,img_size,fwd_decode_ms_per_img,"
                            "nms_ms_per_img,total_ms_per_img,imgs_per_sec\n")
                f.write(f"{batch_size},{self.img_size},{t_fwd:.4f},"
                        f"{t_all - t_fwd:.4f},{t_all:.4f},{1000 / t_all:.1f}\n")
            LOGGER.info(f"Appended speed row to {path}")
        return t_fwd, t_all

    @staticmethod
    def check_task(task):
        if task not in ["train", "val", "test", "speed"]:
            raise ValueError("task argument error: only support 'train' / 'val' / 'test' / 'speed'")

    @staticmethod
    def check_thres(conf_thres, iou_thres, task):
        """(reference: evaler.py:396-406)"""
        if task != "train":
            if task in ("val", "test") and conf_thres > 0.03:
                LOGGER.warning(
                    f"The best conf_thresh when evaluate the model is less than 0.03, while you set it to: {conf_thres}"
                )
            if task == "speed" and conf_thres < 0.4:
                LOGGER.warning(
                    f"The best conf_thresh when test the speed of the model is larger than 0.4, while you set it to: {conf_thres}"
                )

    @staticmethod
    def reload_dataset(data, task="val"):
        data = load_data_config(data)
        task = "test" if task == "test" else "val"
        path = data.get(task, "val")
        if not isinstance(path, list):
            path = [path]
        for p in path:
            if not osp.exists(p):
                raise FileNotFoundError(f"Dataset path {p} not found.")
        return data


def _stem(path: str) -> str:
    return osp.splitext(osp.basename(path))[0]


def encode_pred_rows(pred_results, img_paths) -> np.ndarray:
    """COCO prediction dicts -> ``[n, 7]`` float64 rows, the image id encoded
    as the image's index in ``img_paths`` (the dataset's scan order), so
    that string stems survive a numeric gather."""
    idx_of = {_stem(p): i for i, p in enumerate(img_paths)}
    rows = np.zeros((len(pred_results), 7), np.float64)
    for r, p in zip(rows, pred_results):
        r[0] = idx_of[str(p["image_id"])]
        r[1] = p["category_id"]
        r[2:6] = p["bbox"]
        r[6] = p["score"]
    return rows


def decode_pred_rows(rows: np.ndarray, img_paths) -> list:
    out = []
    for r in rows:
        stem = _stem(img_paths[int(r[0])])
        out.append({
            "image_id": int(stem) if stem.isnumeric() else stem,
            "category_id": int(r[1]),
            "bbox": [float(v) for v in r[2:6]],
            "score": float(r[6]),
        })
    return out


def gather_coco_predictions(pred_results, img_paths) -> list:
    """Every rank's COCO prediction rows, in rank order, on every rank (JAX:
    evaler.py:555-578): each rank encodes its rows (``encode_pred_rows``,
    the image as its index in ``img_paths``), the rows are gathered padded
    to the largest count and decoded. The identity for one process."""
    if world_size() == 1:
        return pred_results
    parts = all_gather_rows(encode_pred_rows(pred_results, img_paths))
    return decode_pred_rows(np.concatenate(parts), img_paths)
