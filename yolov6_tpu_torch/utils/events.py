"""Logging and the run's ``args.yaml`` (the port's own copy of
yolov6_tpu/utils/events.py, without the ``yaml`` package, which the machine
with the card lacks), and the TensorBoard tags the trainer logs
(``write_tblog``, ``write_tbimg``) through ``utils/tb_writer.py``.

Every rank but the main one logs warnings only (JAX: events.py:18-60):
``RANK`` decides at import, the process group when ``set_logging`` runs again
once it is up (``parallel/dist.py::initialize_distributed``).

``save_yaml`` writes a flat mapping (identifier keys; scalars and lists of
scalars) as ``key: value`` lines in flow style (strings in double quotes,
``null``, ``true``/``false``, floats with a dot), which ``yaml.safe_load``
reads as the same values and
which ``load_yaml`` reads back through the port's flat-YAML reader
(``utils/data_config.py``).
"""

from __future__ import annotations

import json
import logging
import math
import os

from yolov6_tpu_torch.utils.data_config import load_data_config


def _main_process() -> bool:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", "0")) == 0


def set_logging(name: str = "yolov6_tpu_torch") -> logging.Logger:
    """The package's logger to stderr as bare messages: INFO on the main
    process, WARNING on the other ranks (the package's module loggers
    inherit the level)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO if _main_process() else logging.WARNING)
    logger.propagate = False
    return logger


LOGGER = set_logging()


def _scalar(value, key: str) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if not math.isfinite(value):
            raise ValueError(f"{key}: {value} has no flat-YAML form here")
        text = repr(value)
        mantissa, e, exp = text.partition("e")
        # YAML 1.1 reads a float only with a dot and a signed exponent
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + (e + ("" if exp[:1] in "+-" else "+") + exp if e else "")
    if isinstance(value, str):
        return json.dumps(value)
    raise ValueError(f"{key}: {type(value).__name__} is not a flat-YAML scalar")


def save_yaml(data: dict, save_path: str) -> None:
    """Write ``data`` (str keys; scalars or lists of scalars) as flat YAML."""
    lines = []
    for key, value in data.items():
        if isinstance(value, (list, tuple)):
            text = "[" + ", ".join(_scalar(v, key) for v in value) + "]"
        else:
            text = _scalar(value, key)
        lines.append(f"{key}: {text}")
    # through a temporary name: another rank may be reading the file
    tmp = f"{save_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, save_path)


def load_yaml(file_path: str) -> dict:
    """A flat ``.yaml``/``.yml`` or ``.json`` mapping as a dict."""
    return load_data_config(file_path)


def write_tblog(tblogger, epoch, results, lrs, losses) -> None:
    """The epoch's scalars at step ``epoch + 1`` (JAX: events.py:74-83)."""
    tblogger.add_scalar("val/mAP@0.5", results[0], epoch + 1)
    tblogger.add_scalar("val/mAP@0.50:0.95", results[1], epoch + 1)
    tblogger.add_scalar("train/iou_loss", losses[0], epoch + 1)
    tblogger.add_scalar("train/dist_focalloss", losses[1], epoch + 1)
    tblogger.add_scalar("train/cls_loss", losses[2], epoch + 1)
    tblogger.add_scalar("x/lr0", lrs[0], epoch + 1)
    tblogger.add_scalar("x/lr1", lrs[1], epoch + 1)
    tblogger.add_scalar("x/lr2", lrs[2], epoch + 1)


def write_tbimg(tblogger, imgs, step, type="train") -> None:
    """HWC RGB images at step ``step + 1``: the train batch as
    ``train_batch``, val predictions as ``val_img_1``... (JAX:
    events.py:86-92)."""
    if type == "train":
        tblogger.add_image("train_batch", imgs, step + 1, dataformats="HWC")
    elif type == "val":
        for idx, img in enumerate(imgs):
            tblogger.add_image(f"val_img_{idx + 1}", img, step + 1, dataformats="HWC")
