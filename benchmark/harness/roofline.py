"""The yardstick of the kernels and of the whole step: the card's
published peaks, the tap arithmetic that the kernels' counts share, and
each hand kernel's yardstick file.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores
(the kernels' arithmetic), 989 TFLOP/s in bfloat16 (the model's compute
dtype, the basis of MFU).

A kernel's least time is the larger of its bytes over the bandwidth and
its operations over the float32 peak; its roofline share is that over its
measured time.  Bytes count each input byte the call needs read once and
each output byte written once, from the shapes and rois of its call,
whatever implements it.

Each hand kernel brings ``benchmark/kernels/<kernel>.py`` (the file's name,
a Python identifier, is the kernel's name here, in ``Launches.calls`` and
in a reader's ``reading.launches``), with four parts:

* ``SEAMS``: the (module, attribute) of each program function that launches
  the kernel, which ``Launches`` wraps;
* ``record(args, kwargs, out)``: what a call keeps (device copies, no host
  sync), or None for a call it does not count;
* ``is_kernel(name)``: whether a device record of the trace is the
  kernel's own;
* ``cost(call)``: the (bytes, operations) of a kept call.
"""

from __future__ import annotations

import importlib
import math
import os

import torch

from ..reference.glass.ops.roi_align_rotated import bilinear_plain

KERNELS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "kernels")

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def touched_rows(meta, rois, levels, grid, out_hw) -> int:
    """Distinct packed rows the bilinear taps of in-bounds samples read."""
    ph_n, pw_n = out_hw
    if rois.shape[0] == 0:
        return 0
    m = meta[levels.long()]
    scale, height, width, base = m[:, 0], m[:, 1], m[:, 2], m[:, 3].long()
    cx = rois[:, 0] * scale - 0.5
    cy = rois[:, 1] * scale - 0.5
    rw, rh = rois[:, 2] * scale, rois[:, 3] * scale
    th = rois[:, 4] * math.pi / 180.0
    c, s = torch.cos(th), torch.sin(th)
    g_h, g_w = grid[:, 0].float(), grid[:, 1].float()
    ph = torch.arange(ph_n, device=rois.device, dtype=torch.float32)
    pw = torch.arange(pw_n, device=rois.device, dtype=torch.float32)
    seen = []

    def col(t):
        return t[:, None, None]

    for iy in range(int(grid[:, 0].max())):
        yy = (-rh[:, None] / 2.0 + ph[None] * (rh / ph_n)[:, None]) + ((iy + 0.5) * (rh / ph_n) / g_h)[:, None]
        for ix in range(int(grid[:, 1].max())):
            xx = (-rw[:, None] / 2.0 + pw[None] * (rw / pw_n)[:, None]) + ((ix + 0.5) * (rw / pw_n) / g_w)[:, None]
            y = (yy[:, :, None] * col(c) - xx[:, None, :] * col(s)) + col(cy)
            x = (yy[:, :, None] * col(s) + xx[:, None, :] * col(c)) + col(cx)
            (yi, xi, yi1, xi1), ws = bilinear_plain(y, x, col(height), col(width), 1.0)
            on = col((iy < grid[:, 0]) & (ix < grid[:, 1])) & ((ws[0] + ws[1] + ws[2] + ws[3]) > 0)
            wr, br = col(width.long()), col(base)
            for a, b in ((yi, xi), (yi, xi1), (yi1, xi), (yi1, xi1)):
                seen.append(torch.unique((br + a * wr + b)[on]))
    return int(torch.unique(torch.cat(seen)).numel())


def samples(grid, out_hw) -> int:
    return int((grid[:, 0].long() * grid[:, 1].long()).sum()) * int(out_hw[0]) * int(out_hw[1])


def least_s(cost) -> float:
    nbytes, ops = cost
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)


def kernels() -> dict:
    """Every yardstick file of ``benchmark/kernels/`` by its kernel's name."""
    package = __package__.rsplit(".", 1)[0] + ".kernels"
    return {f[:-3]: importlib.import_module(f"{package}.{f[:-3]}")
            for f in sorted(os.listdir(KERNELS_DIR)) if f.endswith(".py") and not f.startswith("_")}


def share(calls: list, kind: str, trace) -> "float | None":
    """The kernel's roofline share over the traced window: the least time
    of its calls over the device time of its records; None when the window
    ran none."""
    kernel = kernels()[kind]
    secs = sum(t for _, t in trace.kernels(kernel.is_kernel))
    if not calls or secs <= 0:
        return None
    return 100.0 * sum(least_s(kernel.cost(c)) for c in calls) / secs


class Launches:
    """Records every call of each kernel of ``kernels()`` while ``on``, as
    its file's ``record`` keeps it, by wrapping the program functions its
    ``SEAMS`` name."""

    def __init__(self):
        self.on = False
        self.calls = {name: [] for name in kernels()}
        self.orig = []

    def install(self):
        for name, kernel in kernels().items():
            for where, attr in kernel.SEAMS:
                owner = importlib.import_module(where)
                fn = getattr(owner, attr)
                self.orig.append((owner, attr, fn))
                setattr(owner, attr, self._wrap(name, kernel.record, fn))
        return self

    def _wrap(self, name, record, fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.on:
                call = record(args, kwargs, out)
                if call is not None:
                    self.calls[name].append(call)
            return out
        return recorded

    def remove(self):
        for owner, attr, fn in reversed(self.orig):
            setattr(owner, attr, fn)
        self.orig = []
