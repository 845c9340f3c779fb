"""TensorRT int8 calibrator + calibration image stream (port of
yolov6_tpu/quant/trt_calibrator.py: images are read by the port's
data/image_io.py and letterboxed by its data/data_augment.py, not cv2).

Mirror of the reference deploy/TensorRT/calibrator.py:28-104: a
``DataLoader`` that letterboxes calibration images into fixed fp32 batches,
and an ``IInt8MinMaxCalibrator`` implementation with file-backed
calibration-cache read/write. The batch stream and the cache IO are plain
numpy/stdlib and fully tested here; only the calibrator class itself is
gated on a ``tensorrt`` (+ cuda buffer) install, which this environment
lacks. The cache layout matches what export/onnx_quant.py's
``save_calib_cache_file`` emits (TRT-8XXX header + per-tensor be-float32
hex rows), so caches produced by either path interoperate.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import struct
from typing import Dict, List

import numpy as np

IMG_FORMATS = [".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".dng",
               ".webp", ".mpo"]
IMG_FORMATS += [f.upper() for f in IMG_FORMATS]


def process_image(img_src: np.ndarray, img_size, stride: int = 32) -> np.ndarray:
    """Letterbox + BGR->RGB + CHW + /255 (reference calibrator.py:63-71).
    TRT engines consume NCHW; this intentionally differs from the NHWC
    device path."""
    from yolov6_tpu_torch.data.data_augment import letterbox

    image = letterbox(img_src, img_size, auto=False)[0]
    image = image.transpose((2, 0, 1))[::-1]
    return np.ascontiguousarray(image).astype(np.float32) / 255.0


class CalibrationDataLoader:
    """Fixed-size fp32 NCHW batch stream over a calibration image directory
    (reference calibrator.py:73-104)."""

    def __init__(self, batch_size: int, batch_num: int, calib_img_dir: str,
                 input_w: int, input_h: int):
        self.index = 0
        self.length = batch_num
        self.batch_size = batch_size
        self.input_h, self.input_w = input_h, input_w
        self.img_list = sorted(
            p for p in glob.glob(osp.join(calib_img_dir, "*"))
            if osp.splitext(p)[-1] in IMG_FORMATS
        )
        if len(self.img_list) < batch_size * batch_num:
            raise ValueError(
                f"{calib_img_dir} must contain at least "
                f"{batch_size * batch_num} images to calibrate "
                f"(found {len(self.img_list)})"
            )
        self.calibration_data = np.zeros(
            (batch_size, 3, input_h, input_w), np.float32)

    def reset(self) -> None:
        self.index = 0

    def next_batch(self) -> np.ndarray:
        from yolov6_tpu_torch.data.image_io import imread

        if self.index >= self.length:
            return np.array([])
        for i in range(self.batch_size):
            path = self.img_list[i + self.index * self.batch_size]
            img = imread(path)  # raises for a missing or unreadable file
            self.calibration_data[i] = process_image(
                img, [self.input_h, self.input_w], 32)
        self.index += 1
        return np.ascontiguousarray(self.calibration_data, np.float32)

    def __len__(self) -> int:
        return self.length


def read_calib_cache_file(cache_file: str) -> Dict[str, float]:
    """Parse a TRT calibration cache back to {tensor: scale} (the inverse
    of export/onnx_quant.save_calib_cache_file). Skips the header line."""
    out: Dict[str, float] = {}
    with open(cache_file) as f:
        lines = f.read().splitlines()
    for line in lines[1:]:
        if not line.strip():
            continue
        name, _, hexv = line.rpartition(": ")
        out[name] = struct.unpack("!f", bytes.fromhex(hexv))[0]
    return out


def make_calibrator(stream: CalibrationDataLoader, cache_file: str = ""):
    """Build the trt.IInt8MinMaxCalibrator (reference calibrator.py:28-60).
    Gated on tensorrt + pycuda, absent here; the stream/cache logic above
    carries all the testable behavior."""
    try:
        import tensorrt as trt  # vendor-gated
        import pycuda.driver as cuda
        import pycuda.autoinit  # noqa: F401
    except ImportError as e:  # pragma: no cover — exercised via fake vendor
        raise RuntimeError(
            "tensorrt/pycuda are not installed — run on a TRT machine; the "
            "calibration stream and cache files themselves are portable"
        ) from e

    class Calibrator(trt.IInt8MinMaxCalibrator):
        def __init__(self):
            trt.IInt8MinMaxCalibrator.__init__(self)
            self.stream = stream
            self.d_input = cuda.mem_alloc(stream.calibration_data.nbytes)
            self.cache_file = cache_file
            stream.reset()

        def get_batch_size(self):
            return self.stream.batch_size

        def get_batch(self, names: List[str]):
            batch = self.stream.next_batch()
            if not batch.size:
                return None
            cuda.memcpy_htod(self.d_input, batch)
            return [int(self.d_input)]

        def read_calibration_cache(self):
            if self.cache_file and os.path.exists(self.cache_file):
                with open(self.cache_file, "rb") as f:
                    return f.read()
            return None

        def write_calibration_cache(self, cache):
            with open(self.cache_file, "wb") as f:
                f.write(cache)

    return Calibrator()
