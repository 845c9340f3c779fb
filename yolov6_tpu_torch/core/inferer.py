"""Inference on image files and drawing of the detections (port of
yolov6_tpu/core/inferer.py:32-258).

The device function (x / 255 in the model's dtype, forward, decode, NMS with
``max_nms=2000``) is one function, kept across frames; on a CUDA tensor its
keep is the NMS kernel. Letterboxing, drawing and writing stay on the host.

The drawn image is written under the source's own name by
``image_io.imwrite``, in the format its suffix names, as ``cv2.imwrite``
writes it (a JPEG source's drawn image is the JPEG cv2 would write). A
video's frames are read by ``data/video.py::VideoCapture``, each drawn with
the JAX inferer's FPS overlay and written to ``<stem>.mp4`` by
``data/video.py::VideoWriter`` (MPEG-4 Part 2, every frame an I-VOP), at the
capture's fps and size; its label rows go to ``labels/<stem>.txt``, frame
after frame. Departures from the JAX inferer, for what the machine with the
card lacks (no cv2): boxes, labels and the overlay are drawn by
``utils/draw.py`` (cv2's geometry and text sizes, the port's own font);
webcam and ``view_img`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from collections import deque

import numpy as np
import torch

from yolov6_tpu_torch.data.data_augment import letterbox
from yolov6_tpu_torch.data.datasets import LoadData
from yolov6_tpu_torch.data.image_io import imwrite
from yolov6_tpu_torch.data.video import (
    CAP_PROP_FPS, CAP_PROP_FRAME_HEIGHT, CAP_PROP_FRAME_WIDTH, VideoWriter,
)
from yolov6_tpu_torch.ops.nms import non_max_suppression
from yolov6_tpu_torch.utils import draw
from yolov6_tpu_torch.utils.checkpoint import load_state_dict_file
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.data_config import load_data_config
from yolov6_tpu_torch.utils.device import resolve_device

INFER_MAX_NMS = 2000  # the JAX inferer's candidate cap (inferer.py:74)


def make_infer_fn(model, half: bool, device, max_nms: int = INFER_MAX_NMS):
    """``infer(imgs_u8 NHWC, conf_thres, iou_thres, max_det, agnostic,
    class_mask) -> (dets [b, max_det, 6], valid [b, max_det])`` for ``model``
    on ``device`` (the JAX inferer's ``_infer``; ``hub.predict`` keeps the
    NMS's own ``max_nms``). ``half`` runs the forward under bf16 autocast;
    decode and NMS run in fp32."""
    dtype = torch.bfloat16 if half else torch.float32

    @torch.inference_mode()
    def infer(imgs_u8, conf_thres, iou_thres, max_det, agnostic, class_mask):
        x = torch.as_tensor(imgs_u8, device=device).permute(0, 3, 1, 2).to(dtype) / 255.0
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=half):
            head_out, _ = model(x.contiguous())
        preds = model.decode(head_out)
        return non_max_suppression(
            preds, conf_thres, iou_thres, max_det=max_det, max_nms=max_nms,
            multi_label=False, agnostic=agnostic, class_mask=class_mask,
        )

    return infer


class Inferer:
    def __init__(self, source: str, webcam: bool, webcam_addr: str, weights: str, config: str,
                 yaml_path: str, img_size, half: bool, device="cuda"):
        """``weights`` is a ``torch.save``d state dict of the port or an
        upstream YOLOv6 ``.pt`` (``utils/checkpoint.py::load_state_dict_file``); ``yaml_path`` a
        dataset description with ``nc`` and ``names``."""
        self.device = resolve_device(device)
        self.img_size = [img_size, img_size] if isinstance(img_size, int) else list(img_size)
        self.half = half

        data = load_data_config(yaml_path)
        self.class_names = data["names"]
        self.model = load_state_dict_file(weights, Config.fromfile(config), device=self.device)
        if self.model.num_classes != data["nc"]:
            raise ValueError(f"{weights} predicts {self.model.num_classes} classes, "
                             f"{yaml_path} has nc={data['nc']}")
        self.stride = max(self.model.strides)

        self.files = LoadData(source, webcam, webcam_addr)
        self.source = source
        self._infer = make_infer_fn(self.model, half, self.device)

    def process_image(self, img_src):
        """Letterbox + RGB + uint8 NHWC (reference: inferer.py:161-171)."""
        image = letterbox(img_src, self.img_size, auto=False, stride=self.stride)[0]
        image = np.ascontiguousarray(image[:, :, ::-1])  # BGR->RGB, HWC
        return image[None]

    @staticmethod
    def rescale(ori_shape, boxes, target_shape):
        """Letterboxed boxes -> source-image coords (reference: inferer.py:173-188)."""
        ratio = min(ori_shape[0] / target_shape[0], ori_shape[1] / target_shape[1])
        padding = (ori_shape[1] - target_shape[1] * ratio) / 2, (ori_shape[0] - target_shape[0] * ratio) / 2
        boxes = boxes.copy()
        boxes[:, [0, 2]] -= padding[0]
        boxes[:, [1, 3]] -= padding[1]
        boxes[:, :4] /= ratio
        boxes[:, 0] = boxes[:, 0].clip(0, target_shape[1])
        boxes[:, 1] = boxes[:, 1].clip(0, target_shape[0])
        boxes[:, 2] = boxes[:, 2].clip(0, target_shape[1])
        boxes[:, 3] = boxes[:, 3].clip(0, target_shape[0])
        return boxes

    def infer(
        self,
        conf_thres: float,
        iou_thres: float,
        classes,
        agnostic_nms: bool,
        max_det: int,
        save_dir: str,
        save_txt: bool,
        save_img: bool,
        hide_labels: bool,
        hide_conf: bool,
        view_img: bool = False,
    ):
        """Per-frame loop (reference: inferer.py:70-159)."""
        if view_img:
            raise NotImplementedError("view_img shows frames with cv2.imshow, which the port "
                                      "does not have")
        class_mask = None
        if classes is not None:
            mask = np.zeros(len(self.class_names), np.float32)
            mask[np.asarray(classes)] = 1.0
            class_mask = torch.from_numpy(mask).to(self.device)

        vid_path, vid_writer = None, None
        fps_calculator = CalcFPS()
        try:
            for img_src, img_path, vid_cap in self.files:
                img = self.process_image(img_src)
                t1 = time.perf_counter()
                dets, valid = self._infer(img, conf_thres, iou_thres, max_det, agnostic_nms,
                                          class_mask)
                dets = dets[0][valid[0]].cpu().numpy()
                t2 = time.perf_counter()
                fps_calculator.update(1.0 / (t2 - t1))
                avg_fps = fps_calculator.accumulate()

                rel_path = osp.relpath(osp.dirname(img_path), osp.dirname(self.source)) \
                    if not osp.isfile(self.source) else ""
                save_path = osp.join(save_dir, rel_path, osp.basename(img_path))
                txt_path = osp.join(save_dir, rel_path, "labels", osp.splitext(osp.basename(img_path))[0])
                os.makedirs(osp.dirname(save_path), exist_ok=True)

                gn = np.array(img_src.shape)[[1, 0, 1, 0]]
                img_ori = img_src.copy()
                if len(dets):
                    dets[:, :4] = self.rescale(img.shape[1:3], dets[:, :4], img_src.shape[:2])
                    for *xyxy, conf, cls in reversed(dets):
                        if save_txt:
                            xywh = (self.box_convert(np.array(xyxy).reshape(1, 4)) / gn).reshape(-1).tolist()
                            os.makedirs(osp.dirname(txt_path), exist_ok=True)
                            with open(txt_path + ".txt", "a") as f:
                                f.write(("%g " * 6).rstrip() % (cls, *xywh, conf) + "\n")
                        if save_img:
                            class_num = int(cls)
                            label = None if hide_labels else (
                                self.class_names[class_num] if hide_conf
                                else f"{self.class_names[class_num]} {conf:.2f}"
                            )
                            self.plot_box_and_label(
                                img_ori, max(round(sum(img_ori.shape) / 2 * 0.003), 2),
                                xyxy, label, color=self.generate_colors(class_num, True),
                            )
                if self.files.type == "video":
                    self.draw_text(img_ori, f"FPS: {avg_fps:0.1f}", pos=(20, 20), font_scale=1.0,
                                   text_color=(204, 85, 17), text_color_bg=(255, 255, 255),
                                   font_thickness=2)
                if save_img:
                    if self.files.type == "image":
                        imwrite(save_path, img_ori)
                    else:  # the JAX inferer's video branch (inferer.py:176-192)
                        if vid_path != save_path:
                            vid_path = save_path
                            if vid_writer is not None:
                                vid_writer.release()
                            if vid_cap:
                                fps = vid_cap.get(CAP_PROP_FPS)
                                w = int(vid_cap.get(CAP_PROP_FRAME_WIDTH))
                                h = int(vid_cap.get(CAP_PROP_FRAME_HEIGHT))
                            else:
                                fps, w, h = 30, img_ori.shape[1], img_ori.shape[0]
                            save_path = osp.splitext(save_path)[0] + ".mp4"
                            vid_writer = VideoWriter(save_path, fps, (w, h))
                        vid_writer.write(img_ori)
        finally:
            if vid_writer is not None:
                vid_writer.release()

    @staticmethod
    def box_convert(x):
        y = np.copy(x)
        y[:, 0] = (x[:, 0] + x[:, 2]) / 2
        y[:, 1] = (x[:, 1] + x[:, 3]) / 2
        y[:, 2] = x[:, 2] - x[:, 0]
        y[:, 3] = x[:, 3] - x[:, 1]
        return y

    draw_text = staticmethod(draw.draw_text)
    plot_box_and_label = staticmethod(draw.plot_box_and_label)

    @staticmethod
    def generate_colors(i, bgr=False):
        hex_colors = (
            "FF3838", "FF9D97", "FF701F", "FFB21D", "CFD231", "48F90A", "92CC17",
            "3DDB86", "1A9334", "00D4BB", "2C99A8", "00C2FF", "344593", "6473FF",
            "0018EC", "8438FF", "520085", "CB38FF", "FF95C8", "FF37C7",
        )
        palette = []
        for c in hex_colors:
            palette.append(tuple(int(f"0x{c[i:i + 2]}", 16) for i in (0, 2, 4)))
        num = len(palette)
        color = palette[int(i) % num]
        return (color[2], color[1], color[0]) if bgr else color


class CalcFPS:
    """50-sample FPS average (reference: inferer.py:284-295)."""

    def __init__(self, nsamples: int = 50):
        self.framerate = deque(maxlen=nsamples)

    def update(self, duration: float):
        self.framerate.append(duration)

    def accumulate(self):
        if len(self.framerate) > 1:
            return float(np.average(self.framerate))
        return 0.0
