"""Python-module config system (reference: yolov6/utils/config.py).

Configs are plain ``.py`` files defining ``model``, ``solver`` and
``data_aug`` dicts. This is the port's own copy of yolov6_tpu/utils/config.py:
an attribute-access dict, with the config module loaded by importlib.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types
import uuid
from typing import Any


class ConfigDict(dict):
    """dict with attribute access; a missing attribute raises AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(name) from None
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    @classmethod
    def _convert(cls, obj: Any) -> Any:
        if isinstance(obj, dict):
            return cls({k: cls._convert(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls._convert(v) for v in obj)
        return obj

    def copy(self) -> "ConfigDict":
        return ConfigDict._convert(dict(self))


class Config(ConfigDict):
    """A loaded config file; behaves as a nested attribute dict."""

    @staticmethod
    def _file2dict(filename: str) -> tuple[dict, str]:
        filename = str(filename)
        if not filename.endswith(".py"):
            raise OSError("only .py configs are supported")
        if not os.path.exists(filename):
            raise FileNotFoundError(filename)
        module_name = f"_yolov6_tpu_torch_cfg_{uuid.uuid4().hex}"
        spec = importlib.util.spec_from_file_location(module_name, filename)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = mod
        try:
            spec.loader.exec_module(mod)
            cfg_dict = {
                k: v
                for k, v in vars(mod).items()
                if not k.startswith("__") and not isinstance(v, types.ModuleType)
            }
        finally:
            sys.modules.pop(module_name, None)
        with open(filename) as f:
            cfg_text = f.read()
        return cfg_dict, cfg_text

    @staticmethod
    def fromfile(filename: str) -> "Config":
        cfg_dict, cfg_text = Config._file2dict(filename)
        cfg = Config(ConfigDict._convert(cfg_dict))
        dict.__setitem__(cfg, "_cfg_text", cfg_text)
        dict.__setitem__(cfg, "_filename", str(filename))
        return cfg

    @property
    def filename(self) -> str:
        return dict.get(self, "_filename", "")

    @property
    def text(self) -> str:
        return dict.get(self, "_cfg_text", "")

    def get(self, key, default=None):
        return dict.get(self, key, default)
