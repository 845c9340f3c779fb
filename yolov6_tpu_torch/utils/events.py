"""Logging and the run's ``args.yaml`` (the port's own copy of
yolov6_tpu/utils/events.py, without the ``yaml`` package, which the machine
with the card lacks, and without TensorBoard).

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

from yolov6_tpu_torch.utils.data_config import load_data_config


def set_logging(name: str = "yolov6_tpu_torch") -> logging.Logger:
    """The package's logger, INFO to stderr as bare messages."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO)
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
    with open(save_path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_yaml(file_path: str) -> dict:
    """A flat ``.yaml``/``.yml`` or ``.json`` mapping as a dict."""
    return load_data_config(file_path)
