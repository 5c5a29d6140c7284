"""A light per-image prediction container (host-side, numpy-backed).

The de-facto data model of the reference public API is detectron2's
``Instances`` (fields aligned on a shared first dimension, boolean/index
slicing, an ``image_size``).  This is the framework-native equivalent used
by the inference runner, post-processors and evaluators; device code uses
fixed-shape pytrees instead.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np


class Instances:
    def __init__(self, image_size: Tuple[int, int], **fields: Any):
        self._image_size = tuple(int(x) for x in image_size)
        self._fields: Dict[str, Any] = {}
        for k, v in fields.items():
            self.set(k, v)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self._image_size

    def set(self, name: str, value: Any) -> None:
        n = len(value)
        if self._fields:
            assert n == len(self), f"field {name} has length {n}, expected {len(self)}"
        self._fields[name] = value

    def get(self, name: str) -> Any:
        return self._fields[name]

    def has(self, name: str) -> bool:
        return name in self._fields

    def remove(self, name: str) -> None:
        del self._fields[name]

    def get_fields(self) -> Dict[str, Any]:
        return self._fields

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            super().__setattr__(name, value)
        else:
            self.set(name, value)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") or name not in self.__dict__.get("_fields", {}):
            raise AttributeError(name)
        return self._fields[name]

    def __len__(self) -> int:
        for v in self._fields.values():
            return len(v)
        return 0

    def __getitem__(self, item) -> "Instances":
        out = Instances(self._image_size)
        for k, v in self._fields.items():
            out.set(k, v[item] if not isinstance(v, list) else [v[i] for i in np.arange(len(v))[item]])
        return out

    def __iter__(self) -> Iterator["Instances"]:
        for i in range(len(self)):
            yield self[i]

    def __repr__(self) -> str:
        return (
            f"Instances(num={len(self)}, image_size={self._image_size}, "
            f"fields={list(self._fields)})"
        )
