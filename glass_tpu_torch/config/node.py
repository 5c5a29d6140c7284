"""A minimal yacs-compatible configuration node.

The reference stack configures everything through detectron2/yacs ``CfgNode``
YAML files (see reference ``glass/config.py`` and ``configs/*.yaml``).  To let
users bring their released GLASS YAML configs over verbatim, we re-implement
the small subset of yacs semantics those files rely on:

* attribute-style access (``cfg.MODEL.RPN.NMS_THRESH``)
* recursive ``merge_from_file`` / ``merge_from_other_cfg`` with type checking
* ``merge_from_list`` for ``--opts KEY VALUE`` CLI overrides
* ``freeze`` / ``defrost`` and ``clone``

Unknown keys in a merged file raise ``KeyError`` just as yacs does, keeping
config typos loud.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import yaml

_VALID_SCALARS = (int, float, bool, str, type(None))


class CfgNode(dict):
    """Dict subclass with attribute access and yacs-style merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                if isinstance(v, dict) and not isinstance(v, CfgNode):
                    v = CfgNode(v)
                self[k] = v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"Attempted to set {name} on an immutable config")
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"Attempted to set {name} on an immutable config")
        super().__setitem__(name, value)

    # -- mutability -------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def _set_immutable(self, value: bool) -> None:
        self.__dict__[CfgNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def clone(self) -> "CfgNode":
        frozen = self.is_frozen()
        self.defrost()
        out = copy.deepcopy(self)
        if frozen:
            self.freeze()
            out.freeze()
        return out

    # -- merging ----------------------------------------------------------
    def merge_from_file(self, filename: str, allow_unsafe: bool = False) -> None:
        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self.merge_from_other_cfg(CfgNode(loaded))

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_into(other, self, [])

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            last = parts[-1]
            if last not in node:
                raise KeyError(f"Non-existent config key: {key}")
            old = node[last]
            node[last] = _decode_and_check(value, old, key)

    # -- io ---------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CfgNode({super().__repr__()})"


def _decode_and_check(value: Any, old: Any, full_key: str) -> Any:
    """Parse a CLI string override and coerce it to the type of ``old``."""
    if isinstance(value, str):
        try:
            value = yaml.safe_load(value)
        except yaml.YAMLError:
            pass
    return _check_type(value, old, full_key)


def _check_type(new: Any, old: Any, full_key: str) -> Any:
    if old is None or new is None:
        return new
    # yacs-compatible casts: list<->tuple, int->float, "(a, b)" strings
    if isinstance(old, (tuple, list)) and isinstance(new, str):
        # Released configs write tuples as YAML strings, e.g. "(800, 1200)".
        import ast

        try:
            parsed = ast.literal_eval(new)
        except (ValueError, SyntaxError):
            raise ValueError(
                f"Cannot parse {new!r} as a sequence for key {full_key}"
            )
        new = parsed
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, float) and isinstance(new, int) and not isinstance(new, bool):
        return float(new)
    if type(new) is type(old):
        return new
    # allow str -> numeric promotion leniency used by some released configs
    if isinstance(old, (int, float)) and isinstance(new, (int, float)) \
            and not isinstance(new, bool) and not isinstance(old, bool):
        return new
    raise ValueError(
        f"Type mismatch ({type(old).__name__} vs {type(new).__name__}) for key {full_key}"
    )


def _merge_into(src: CfgNode, dst: CfgNode, key_path: List[str]) -> None:
    for k, v in src.items():
        full_key = ".".join(key_path + [k])
        if k not in dst:
            raise KeyError(f"Non-existent config key: {full_key}")
        if isinstance(v, CfgNode):
            if not isinstance(dst[k], CfgNode):
                raise ValueError(f"Cannot merge dict into non-dict key {full_key}")
            _merge_into(v, dst[k], key_path + [k])
        else:
            dst[k] = _check_type(copy.deepcopy(v), dst[k], full_key)
