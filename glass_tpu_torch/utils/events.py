"""Scalar metric storage: a copy of glass_tpu's ``utils/events.py``, the
reference's EventStorage equivalent.

Accumulates scalars per iteration and writes a ``metrics.json`` lines file
(the same artifact d2's JSONWriter emits), so downstream tooling can diff
training curves.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Optional


class EventStorage:
    def __init__(self, output_file: Optional[str] = None):
        self._iter = 0
        self._latest: Dict[str, float] = {}
        self._history = defaultdict(list)
        self._output_file = output_file
        self._fh = open(output_file, "a") if output_file else None

    def step(self, iteration: int) -> None:
        if self._latest and self._fh:
            rec = {"iteration": self._iter, **self._latest}
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        self._iter = iteration
        self._latest = {}

    def put_scalar(self, name: str, value: float) -> None:
        value = float(value)
        self._latest[name] = value
        self._history[name].append((self._iter, value))

    def flush(self) -> None:
        """Write any pending scalars for the current iteration (call at the
        end of training so the last logged iteration reaches disk)."""
        if self._latest and self._fh:
            rec = {"iteration": self._iter, **self._latest}
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
            self._latest = {}

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)

    def history(self, name: str):
        return list(self._history[name])

    @property
    def iter(self) -> int:
        return self._iter
