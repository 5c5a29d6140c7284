"""The yardstick of the kernels and of the whole step: the card's
published peaks, and each hand kernel's bytes and operations worked out
from the shapes and rois of its call, whatever implements it.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores
(the kernels' arithmetic), 989 TFLOP/s in bfloat16 (the model's compute
dtype, the basis of MFU).

A kernel's least time is the larger of its bytes over the bandwidth and
its operations over the float32 peak; its roofline share is that over its
measured time.  Bytes count each input byte the call needs read once and
each output byte written once:

* K1 (rotated RoIAlign forward): the pooled output (R, ph, pw, C), plus the
  distinct feature rows of C channels that the bilinear taps of in-bounds
  samples touch; operations: 8 per channel per sample (four taps, a
  multiply and an add each).
* K1b (its backward): the upstream gradient read, plus the dense gradient
  of the packed features (n_rows, C) written once, as the call returns it;
  operations as K1's.
* K2 (rotated crops of the image): the crops (B, R, OH, OW, 3) written,
  plus the distinct pixels of three channels the taps touch; operations as
  K1's.
"""

from __future__ import annotations

import math

import torch

from ..reference.glass.ops.roi_align_rotated import adaptive_grid, bilinear_plain, fixed_grid

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


def k1_cost(call: dict):
    """(bytes, operations) of one K1 call."""
    c, elt = call["channels"], call["elt"]
    out = call["rois"].shape[0] * call["out_hw"][0] * call["out_hw"][1] * c * elt
    rows = touched_rows(call["meta"], call["rois"], call["levels"], call["grid"], call["out_hw"])
    return out + rows * c * elt, 8 * c * samples(call["grid"], call["out_hw"])


def k1b_cost(call: dict):
    """(bytes, operations) of one K1b call."""
    c = call["channels"]
    grad_in = call["rois"].shape[0] * call["out_hw"][0] * call["out_hw"][1] * c * call["elt"]
    return grad_in + call["n_rows"] * c * call["out_elt"], 8 * c * samples(call["grid"], call["out_hw"])


def k2_cost(call: dict):
    """(bytes, operations) of one K2 call over a batch."""
    rois, out_hw = call["rois"], call["out_hw"]
    b, h, w, _ = call["images_shape"]
    total_rows = 0
    ops = 0
    for i in range(b):
        r = rois[i].float()
        grid = (fixed_grid(r.shape[0], call["sampling_ratio"], r.device) if call["sampling_ratio"] > 0
                else adaptive_grid(r[:, 3], r[:, 2], out_hw, call["max_sampling_ratio"]))
        meta = torch.tensor([[1.0, float(h), float(w), 0.0]], device=r.device)
        levels = torch.zeros((r.shape[0],), dtype=torch.int32, device=r.device)
        total_rows += touched_rows(meta, r, levels, grid, out_hw)
        ops += 8 * 3 * samples(grid, out_hw)
    out = rois.shape[0] * rois.shape[1] * out_hw[0] * out_hw[1] * 3 * call["out_elt"]
    return out + total_rows * 3 * call["image_elt"], ops


COSTS = {"k1": k1_cost, "k1b": k1b_cost, "k2": k2_cost}
NAMES = {"k1": lambda n: "roi_align_rotated_kernel" in n,
         "k1b": lambda n: "k1b::" in n,
         "k2": lambda n: "crop_rois_kernel" in n}


def least_s(cost) -> float:
    nbytes, ops = cost
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)


def share(calls: list, kind: str, trace) -> "float | None":
    """The kernel's roofline share over the traced window: the least time
    of its calls over the device time of its records; None when the window
    ran none."""
    secs = sum(t for _, t in trace.kernels(NAMES[kind]))
    if not calls or secs <= 0:
        return None
    return 100.0 * sum(least_s(COSTS[kind](c)) for c in calls) / secs


class Launches:
    """Records the shapes and rois of every K1, K1b and K2 call while
    ``on`` (device copies, no host sync), by wrapping the program's
    launch sites."""

    def __init__(self, rar_module, crop_module, glass_rcnn_module):
        self.mods = (rar_module, crop_module, glass_rcnn_module)
        self.on = False
        self.calls = {"k1": [], "k1b": [], "k2": []}

    def install(self):
        rar, crop, rcnn = self.mods
        self.orig = (rar._pool_forward, rar.roi_align_rotated_packed_backward, crop.crop_rois_batched,
                     getattr(rcnn, "crop_rois_batched", None))

        def pool_forward(flat, meta, rois, levels, grid, output_size):
            if self.on and flat.is_cuda:
                self.calls["k1"].append({"meta": meta.detach().clone(), "rois": rois.detach().float().clone(),
                                         "levels": levels.clone(), "grid": grid.clone(),
                                         "out_hw": tuple(int(v) for v in output_size),
                                         "channels": flat.shape[1], "elt": flat.element_size()})
            return self.orig[0](flat, meta, rois, levels, grid, output_size)

        def pool_backward(grad_out, meta, rois, levels, grid, n_rows, out_dtype=torch.float32, **kw):
            if self.on and grad_out.is_cuda:
                self.calls["k1b"].append({"rois": rois.detach().clone(), "grid": grid.clone(),
                                          "out_hw": tuple(grad_out.shape[1:3]), "channels": grad_out.shape[-1],
                                          "elt": grad_out.element_size(), "n_rows": int(n_rows),
                                          "out_elt": torch.empty((), dtype=out_dtype).element_size()})
            return self.orig[1](grad_out, meta, rois, levels, grid, n_rows, out_dtype=out_dtype, **kw)

        def crop_batched(images, rois, out_hw=(128, 128), sampling_ratio=1, max_sampling_ratio=2,
                         normalize=None):
            out = self.orig[2](images, rois, out_hw, sampling_ratio, max_sampling_ratio, normalize)
            if self.on and images.is_cuda:
                self.calls["k2"].append({"images_shape": tuple(images.shape),
                                         "image_elt": images.element_size(), "rois": rois.detach().clone(),
                                         "out_hw": tuple(int(v) for v in out_hw),
                                         "sampling_ratio": int(sampling_ratio),
                                         "max_sampling_ratio": max_sampling_ratio,
                                         "out_elt": out.element_size()})
            return out

        rar._pool_forward = pool_forward
        rar.roi_align_rotated_packed_backward = pool_backward
        crop.crop_rois_batched = crop_batched
        if self.orig[3] is not None:
            rcnn.crop_rois_batched = crop_batched
        return self

    def remove(self):
        rar, crop, rcnn = self.mods
        rar._pool_forward, rar.roi_align_rotated_packed_backward, crop.crop_rois_batched = self.orig[:3]
        if self.orig[3] is not None:
            rcnn.crop_rois_batched = self.orig[3]
