"""Explicit component registries (the port's copy of yolov6_tpu/utils/registry.py).

The reference resolves backbone/neck classes with ``eval()`` of a type string
(reference: yolov6/models/yolo.py:70-71); registries avoid that.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator


class Registry:
    """A name -> callable registry with decorator support."""

    def __init__(self, name: str):
        self._name = name
        self._entries: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def register(self, name: str | None = None) -> Callable:
        def _wrap(obj):
            key = name or obj.__name__
            if key in self._entries and self._entries[key] is not obj:
                raise KeyError(f"{key!r} already registered in {self._name}")
            self._entries[key] = obj
            return obj

        return _wrap

    def get(self, key: str) -> Any:
        if key not in self._entries:
            raise KeyError(
                f"{key!r} not found in registry {self._name!r}; "
                f"available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def keys(self):
        return self._entries.keys()


BACKBONES = Registry("backbones")
NECKS = Registry("necks")
