"""Hub-style model loaders and one-shot prediction (port of hubconf.py:22-157,
which stays the JAX package's):

    from yolov6_tpu_torch import hub
    model = hub.yolov6s(weights="yolov6s.pt")          # or weights=None: seeded random
    dets = hub.predict(model, "data/images/image1.jpg")  # [n, 6] xyxy, conf, cls
    hub.visualize_detections("data/images/image1.jpg", dets, names, "out.png")

A loader returns the deploy model of ``configs/<name>.py`` on ``device``
(``cuda`` by default; it raises without one), its weights from a
``torch.save``d state dict or an upstream YOLOv6 ``.pt``
(``utils/checkpoint.py::load_state_dict_file``) or, with ``weights=None``, drawn by torch's
initialisers from seed 0. ``half=True`` makes ``predict`` run the forward
under bf16 autocast. ``img_size`` is accepted as the JAX loaders take it;
the port's graphs take any input size, so it changes nothing here. The lite
loaders (``yolov6lite_s/m/l``) build the lite family's deploy graphs, which
are trained at 320: call ``predict(model, source, img_size=320)``.
``visualize_detections`` writes ``save_path`` in the format its suffix names
(``data/image_io.py::imwrite``, as ``cv2.imwrite``).
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from yolov6_tpu_torch.core.inferer import Inferer, make_infer_fn
from yolov6_tpu_torch.data.data_augment import letterbox
from yolov6_tpu_torch.data.image_io import imread, imwrite
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils import draw
from yolov6_tpu_torch.utils.checkpoint import load_state_dict_file
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.device import resolve_device

REPO_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
PREDICT_MAX_NMS = 30000  # non_max_suppression's default, which hubconf.predict keeps


def _create(name: str, weights=None, num_classes: int = 80, img_size: int = 640,
            half: bool = False, device="cuda"):
    device = resolve_device(device)
    cfg = Config.fromfile(osp.join(REPO_ROOT, "configs", f"{name}.py"))
    if weights:
        model = load_state_dict_file(weights, cfg, device=device)
        if model.num_classes != num_classes:
            raise ValueError(f"{weights} predicts {model.num_classes} classes, not {num_classes}")
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model(cfg, num_classes=num_classes, deploy=True, device=device)
    model.hub_half = half
    return model


def yolov6n(weights=None, **kw):
    return _create("yolov6n", weights, **kw)


def yolov6s(weights=None, **kw):
    return _create("yolov6s", weights, **kw)


def yolov6m(weights=None, **kw):
    return _create("yolov6m", weights, **kw)


def yolov6l(weights=None, **kw):
    return _create("yolov6l", weights, **kw)


def yolov6n6(weights=None, **kw):
    return _create("yolov6n6", weights, img_size=1280, **kw)


def yolov6s6(weights=None, **kw):
    return _create("yolov6s6", weights, img_size=1280, **kw)


def yolov6m6(weights=None, **kw):
    return _create("yolov6m6", weights, img_size=1280, **kw)


def yolov6l6(weights=None, **kw):
    return _create("yolov6l6", weights, img_size=1280, **kw)


def yolov6lite_s(weights=None, **kw):
    return _create("yolov6_lite/yolov6_lite_s", weights, img_size=320, **kw)


def yolov6lite_m(weights=None, **kw):
    return _create("yolov6_lite/yolov6_lite_m", weights, img_size=320, **kw)


def yolov6lite_l(weights=None, **kw):
    return _create("yolov6_lite/yolov6_lite_l", weights, img_size=320, **kw)


def predict(model, source, img_size: int = 640, conf_thres: float = 0.25,
            iou_thres: float = 0.45, max_det: int = 300):
    """One-shot inference on an image path or BGR array; returns ``[n, 6]``
    xyxy/conf/cls in source-image pixels (hubconf.predict's flow)."""
    img_src = imread(source) if isinstance(source, str) else source
    img = letterbox(img_src, (img_size, img_size), auto=False)[0]
    img = np.ascontiguousarray(img[:, :, ::-1])[None]
    infer = make_infer_fn(model, getattr(model, "hub_half", False),
                          next(model.parameters()).device, max_nms=PREDICT_MAX_NMS)
    dets, valid = infer(img, conf_thres, iou_thres, max_det, False, None)
    dets = dets[0][valid[0]].cpu().numpy()
    if len(dets):
        dets[:, :4] = Inferer.rescale(img.shape[1:3], dets[:, :4], img_src.shape[:2])
    return dets


def visualize_detections(source, dets, class_names, save_path: str | None = None):
    """Draw ``dets`` on the source image (hubconf.visualize_detections);
    with ``save_path``, write it there (``imwrite``: JPEG, PNG or BMP by the
    suffix)."""
    img = imread(source) if isinstance(source, str) else source.copy()
    for *xyxy, conf, cls in dets:
        draw.plot_box_and_label(
            img, max(round(sum(img.shape) / 2 * 0.003), 2), xyxy,
            f"{class_names[int(cls)]} {conf:.2f}",
            color=Inferer.generate_colors(int(cls), True),
        )
    if save_path:
        imwrite(save_path, img)
    return img
