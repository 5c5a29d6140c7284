"""The traced part of a ``--trace 1`` window: ``torch.profiler`` over the
first units of work of the window, read into what the per-layer readers
take.

* device records: every kernel and copy on the card (not the profiler's
  own buffer requests, nor the device copies of ``record_function``
  spans), with start, end and name;
* ``busy_s``: the union of their intervals; ``window_s``: the traced
  window's length on the host clock, ending in a synchronize;
* ``span_device_s(name)``: the device time of the kernels launched by ops
  that start inside a host span of that name (the program's ``glass.*``
  spans), on any thread: autograd runs the backward on its own;
* the breakdown: the device operations that took most time, and the idle
  gaps between device records, summed by the innermost host op that was
  running at the middle of each gap.
"""

from __future__ import annotations

import bisect
import collections
import time

import numpy as np
import torch

NOT_WORK = ("Activity Buffer Request",)


def _is_device(e):
    return "CUDA" in str(getattr(e, "device_type", ""))


class Traced:
    """Profiles while active; ``summary()`` afterwards."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.window_s = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def summary(self, span_names=()) -> "TraceSummary":
        return TraceSummary(self.prof.events(), self.window_s, span_names)


class TraceSummary:
    def __init__(self, events, window_s, span_names=()):
        self.window_s = window_s
        spans = set(span_names)
        self.records = []  # (name, start_us, end_us)
        cpu = []
        for e in events:
            if _is_device(e):
                if e.name in NOT_WORK or e.name.startswith("glass."):
                    continue
                self.records.append((e.name, e.time_range.start, e.time_range.end))
            else:
                cpu.append(e)
        self.records.sort(key=lambda r: r[1])
        self.busy_s = self._union_s()
        # device time of kernels launched under each named host span
        windows = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu if e.name in spans)
        starts = [w[0] for w in windows]
        self.span_s = collections.Counter()
        self.span_launches = collections.Counter()
        for e in cpu:
            ks = getattr(e, "kernels", None)
            if not ks:
                continue
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start <= windows[i][1]:
                self.span_s[windows[i][2]] += sum(k.duration for k in ks) / 1e6
                self.span_launches[windows[i][2]] += len(ks)
        self.span_count = collections.Counter(w[2] for w in windows)
        host = [(e.name, e.time_range.start, e.time_range.end) for e in cpu if e.name not in NOT_WORK]
        self._cpu_names = [h[0] for h in host]
        self._cpu_t = np.array([[h[1], h[2]] for h in host], dtype=np.float64).reshape(-1, 2)

    def _union_s(self) -> float:
        total, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.records:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def kernels(self, match) -> list:
        """(name, seconds) of the device records whose name ``match``es."""
        return [(n, (e - s) / 1e6) for n, s, e in self.records if match(n)]

    def span_device_s(self, name: str) -> float:
        return self.span_s.get(name, 0.0)

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for n, s, e in self.records:
            by[n] += (e - s) / 1e6
        return [[n[:200], v] for n, v in by.most_common(top)]

    def idle_gaps(self, top: int = 10, labelled: int = 400) -> list:
        """Idle seconds by the innermost host op running at each gap's
        middle, over the ``labelled`` longest gaps."""
        gaps, cur_e = [], None
        for _, s, e in self.records:
            if cur_e is not None and s > cur_e:
                gaps.append((s - cur_e, cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        by = collections.Counter()
        t0, t1 = self._cpu_t[:, 0], self._cpu_t[:, 1]
        for length, g0, g1 in sorted(gaps, reverse=True)[:labelled]:
            mid = (g0 + g1) / 2
            inner = np.nonzero((t0 <= mid) & (t1 >= mid))[0]
            name = self._cpu_names[inner[np.argmin(t1[inner] - t0[inner])]] if len(inner) else "(no host op)"
            by[name] += length / 1e6
        return [[n[:200], v] for n, v in by.most_common(top)]
