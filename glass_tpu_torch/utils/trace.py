"""The port's spans and counters: recorded only while a ``torch.profiler``
session records, free otherwise.

``span(name, rid=None)`` is a context manager around one stage call.  With
no profiler running it returns one shared no-op context: no allocation, no
string work, no clock read (~0.5 us an enter/exit against ~11-15 us for a
bare ``record_function``, torch 2.13 on an Intel Xeon host).  While a profiler
records (``torch.profiler.profile`` sets a process-wide flag, on every
thread) it

* enters ``record_function(name)`` on a thread the profiler traces, so the
  span sits on the profiler's host timeline beside the device records
  (the profiler traces the thread that started it and autograd's threads;
  a worker thread of the program is recorded below but not traced);
* adds its host-clock seconds and one call to ``totals()[name]`` and keeps
  ``(name, rid, thread id, start ns, end ns)`` in ``records()``.

``rid`` ties the spans of one request together; a span given none takes
that of the innermost span open on its thread.  ``count(name, n)`` adds to
a counter, only while recording.  There is no other switch: profile a slow
request, then filter ``records()`` by its ``rid``.
"""

from __future__ import annotations

import threading
import time

import torch
from torch.autograd import profiler as _profiler

_LOCK = threading.Lock()
_TOTALS: dict = {}    # span name -> [seconds, calls]
_COUNTS: dict = {}    # counter name -> n
_RECORDS: list = []   # (name, rid, thread id, start ns, end ns)
_LOCAL = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, rid=None):
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, rid)


def count(name: str, n: int = 1) -> None:
    if not _profiler._is_profiler_enabled:
        return
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def totals() -> dict:
    """``{span: [seconds, calls]}`` and ``{counter: n}``."""
    with _LOCK:
        out = {k: list(v) for k, v in _TOTALS.items()}
        out.update(_COUNTS)
    return out


def records() -> list:
    with _LOCK:
        return list(_RECORDS)


def reset() -> None:
    with _LOCK:
        _TOTALS.clear()
        _COUNTS.clear()
        _RECORDS.clear()


class _Span:
    __slots__ = ("name", "rid", "outer", "rf", "t0")

    def __init__(self, name, rid):
        self.name, self.rid = name, rid

    def __enter__(self):
        self.outer = getattr(_LOCAL, "rid", None)
        if self.rid is None:
            self.rid = self.outer
        _LOCAL.rid = self.rid
        self.rf = None
        if torch._C._autograd._profiler_enabled():  # this thread is traced
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _LOCAL.rid = self.outer
        with _LOCK:
            tot = _TOTALS.setdefault(self.name, [0.0, 0])
            tot[0] += (t1 - self.t0) / 1e9
            tot[1] += 1
            _RECORDS.append((self.name, self.rid, threading.get_ident(), self.t0, t1))
        return False
