"""Path and size helpers (the port's own copy of yolov6_tpu/utils/general.py:13-88,
without ``download_ckpt``: the port downloads nothing)."""

from __future__ import annotations

import glob
import math
import os
from pathlib import Path

from yolov6_tpu_torch.utils.events import LOGGER


def increment_name(path) -> Path:
    """A path that does not exist yet: ``path``, else ``path`` with a counter
    appended (reference: utils/general.py:12-23)."""
    path = Path(path)
    if path.exists():
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(1, 9999):
            p = f"{path}{n}{suffix}"
            if not os.path.exists(p):
                break
        path = Path(p)
    return path


def find_latest_checkpoint(search_dir: str = ".") -> str:
    """The most recently written ``last*_ckpt*`` under ``search_dir``, or ""
    (reference: utils/general.py:26-29)."""
    ckpts = glob.glob(f"{search_dir}/**/last*_ckpt*", recursive=True)
    return max(ckpts, key=os.path.getctime) if ckpts else ""


def make_divisible(x, divisor):
    return math.ceil(x / divisor) * divisor


def check_img_size(imgsz, s=32, floor=0):
    """The image size rounded up to a multiple of the stride ``s``, and at
    least ``floor`` (reference: utils/general.py:109-117)."""
    if isinstance(imgsz, int):
        new_size = max(make_divisible(imgsz, int(s)), floor)
    else:
        new_size = [max(make_divisible(x, int(s)), floor) for x in imgsz]
    if new_size != imgsz:
        LOGGER.warning(f"--img-size {imgsz} must be multiple of max stride {s}, "
                       f"updating to {new_size}")
    return new_size
