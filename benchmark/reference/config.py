"""The reference's view of a configuration: the frozen config of
``benchmark/configs/<name>.json`` with a cell's overrides, as nested
dicts with attribute access (the keys of the program's CfgNode)."""

from __future__ import annotations

import copy

import yaml


class Node(dict):
    """A dict whose keys read as attributes, nested dicts included."""

    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = Node(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name, value):
        self[name] = value


def _cast(value, old):
    """A string override parsed as YAML and coerced to the type it
    replaces (sequences written as "(a, b)" too)."""
    if isinstance(value, str):
        value = yaml.safe_load(value)
        if isinstance(old, (list, tuple)) and isinstance(value, str):
            value = yaml.safe_load(value.replace("(", "[").replace(")", "]"))
    if isinstance(old, float) and isinstance(value, int) and not isinstance(value, bool):
        value = float(value)
    return value


def load(cfg: dict, opts=()) -> Node:
    """``cfg`` (a frozen config's ``cfg``) with ``opts`` (KEY VALUE ...)
    applied."""
    node = Node(copy.deepcopy(cfg))
    opts = list(opts)
    for key, value in zip(opts[0::2], opts[1::2]):
        parent = node
        parts = key.split(".")
        for p in parts[:-1]:
            parent = parent[p]
        if parts[-1] not in parent:
            raise KeyError(f"no config key {key}")
        parent[parts[-1]] = _cast(value, parent[parts[-1]])
    return node
