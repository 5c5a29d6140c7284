"""Rotated RoIAlign (detectron2 ``ROIAlignRotated`` forward) over
channels-last feature maps, in plain PyTorch.

A frozen copy of the plain arithmetic of the port's pooler, kept with the
benchmark so that the reference does not move when the program does:

* rois are ``(cx, cy, w, h, angle_deg)``, scaled by the level's spatial
  scale and shifted by the aligned half-pixel offset,
* each roi is cut into ``ph x pw`` bins, each sampled on a ``g_h x g_w``
  grid: a fixed ``sampling_ratio``, or adaptive ``ceil(extent / pooled)``
  capped at ``max_sampling_ratio`` (glass's bulk grid plus the full grid
  for the first ``large_roi_budget`` large rois),
* bilinear taps are averaged; a sample outside ``[-1, H] x [-1, W]`` adds
  zero.

The gradient is autograd's through the gathers (no hand-written backward).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

def _grid_pair(g):
    """Grid spec (int or (grid_h, grid_w)) -> per-axis pair."""
    if isinstance(g, (tuple, list)):
        gh, gw = g
        return int(gh), int(gw)
    return int(g), int(g)


class PackedPyramid(NamedTuple):
    """Level maps concatenated row-wise: ``flat`` (sum HW, C) and ``meta``
    f32 rows ``(spatial scale, H, W, row offset)``, one per (image, level),
    image-major, ``levels_per_image`` levels an image."""

    flat: torch.Tensor
    meta: torch.Tensor
    levels_per_image: int


def pack_pyramid(features: Sequence[torch.Tensor], scales: Sequence[float]) -> PackedPyramid:
    """features: list of (H_l, W_l, C) maps of one image; scales: per-level
    spatial scale.  One level is a view of its map when that map is
    contiguous; several levels are copied into one buffer."""
    return pack_batch_pyramid([f[None] for f in features], scales)


def pack_batch_pyramid(features: Sequence[torch.Tensor], scales: Sequence[float]) -> PackedPyramid:
    """features: list over levels of (B, H_l, W_l, C) maps (the NHWC view of
    a channels-last (B, C, H, W) map is a contiguous (B H W, C) block);
    scales: per-level spatial scale.  Meta row ``b * L + l`` is level l of
    image b, so one launch pools the rois of every image."""
    b, channels = features[0].shape[0], features[0].shape[-1]
    levels, off = [], 0
    for f, s in zip(features, scales):
        levels.append((float(s), f.shape[1], f.shape[2], off))
        off += f.shape[0] * f.shape[1] * f.shape[2]
    meta = torch.tensor(
        [[s, float(h), float(w), float(o + i * h * w)] for i in range(b) for s, h, w, o in levels],
        dtype=torch.float32, device=features[0].device,
    )
    blocks = [f.reshape(-1, channels) for f in features]
    flat = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=0)
    return PackedPyramid(flat, meta, len(features))


def _scaled_extent(rois: torch.Tensor, meta: torch.Tensor, levels: torch.Tensor):
    scale = meta[levels, 0]
    return rois[:, 3] * scale, rois[:, 2] * scale


def fixed_grid(n: int, sampling_ratio: int, device) -> torch.Tensor:
    return torch.full((n, 2), int(sampling_ratio), dtype=torch.int32, device=device)


def adaptive_grid(rh, rw, output_size, cap) -> torch.Tensor:
    """(R, 2) int32 ``clip(ceil(extent / pooled), 1, cap)`` per axis."""
    ph, pw = output_size
    ch, cw = _grid_pair(cap)
    g_h = torch.clamp(torch.ceil(rh / ph), 1, ch)
    g_w = torch.clamp(torch.ceil(rw / pw), 1, cw)
    return torch.stack([g_h, g_w], dim=1).to(torch.int32)


def split_grid(rh, rw, output_size, bulk, max_sampling_ratio, large_roi_budget,
               rois_per_image: int = 0) -> torch.Tensor:
    """glass_tpu's split-capacity adaptive grid as one per-roi table: the
    bulk grid for every roi, the full ``max_sampling_ratio`` grid for the
    first ``large_roi_budget`` rois (by index) whose d2 grid exceeds the
    bulk grid.  Large rois beyond the budget keep the bulk grid.  With
    ``rois_per_image`` the rois are image-major blocks of that size and each
    image has its own budget, as glass_tpu's per-image pooler calls."""
    ph, pw = output_size
    bh, bw = _grid_pair(bulk)
    grid = adaptive_grid(rh, rw, output_size, (bh, bw))
    fine = adaptive_grid(rh, rw, output_size, max_sampling_ratio)
    is_large = (torch.ceil(rh / ph) > bh) | (torch.ceil(rw / pw) > bw)
    block = rois_per_image or max(rh.shape[0], 1)
    budget = min(int(large_roi_budget), block)
    rank = torch.cumsum(is_large.to(torch.int32).reshape(-1, block), 1).reshape(-1)
    chosen = is_large & (rank <= budget)
    return torch.where(chosen[:, None], fine, grid)


def roi_align_rotated_packed(
    flat: torch.Tensor,
    meta: torch.Tensor,
    rois: torch.Tensor,
    levels: torch.Tensor,
    grid: torch.Tensor,
    output_size,
) -> torch.Tensor:
    """Pool (R, ph, pw, C) from a packed pyramid, in the feature dtype.

    flat (sum HW, C); meta (L, 4) f32; rois (R, 5); levels (R,) int;
    grid (R, 2) int per-roi sampling grid.  Differentiable in ``flat``
    (``RoIAlignRotatedFunction``: K1 forward, K1b backward); the rois carry
    no gradient.
    """
    rois = rois.detach().to(torch.float32)
    levels = levels.to(torch.int32)
    grid = grid.to(torch.int32)
    meta = meta.to(torch.float32)
    return sample_grid_plain(flat, meta, rois, levels, grid, output_size).to(flat.dtype)


def bilinear_plain(y, x, height, width, count):
    """Plain version of ``bilinear_taps`` (csrc/bilinear.cuh) over tensors:
    returns (y_low, x_low, y_high, x_high) int64 and four weights, zero for
    samples outside ``[-1, H] x [-1, W]``.  height/width broadcast with y."""
    outside = (y < -1.0) | (y > height) | (x < -1.0) | (x > width)
    y = torch.clamp(y, min=0.0)
    x = torch.clamp(x, min=0.0)
    yl = torch.minimum(torch.floor(y), height - 1.0)
    xl = torch.minimum(torch.floor(x), width - 1.0)
    y = torch.where(yl >= height - 1.0, yl, y)
    x = torch.where(xl >= width - 1.0, xl, x)
    ly = y - yl
    lx = x - xl
    hy = 1.0 - ly
    hx = 1.0 - lx
    yi = yl.to(torch.int64)
    xi = xl.to(torch.int64)
    yi1 = torch.minimum(yi + 1, height.to(torch.int64) - 1)
    xi1 = torch.minimum(xi + 1, width.to(torch.int64) - 1)
    zero = torch.zeros_like(hy)
    ws = [torch.where(outside, zero, w) / count for w in (hy * hx, hy * lx, ly * hx, ly * lx)]
    return (yi, xi, yi1, xi1), ws


def plain_samples(meta, rois, levels, grid, output_size):
    """The samples of every bin in the kernels' order: yields, per grid
    position (iy, ix), the four tap rows (R, ph, pw) int64 into the packed
    rows and their weights (divided by the bin's count, zero for a sample
    outside the map or beyond the roi's own grid)."""
    if rois.shape[0] == 0:
        return
    ph_n, pw_n = (int(v) for v in output_size)
    dev = rois.device
    m = meta[levels.long()]
    scale, height, width, base = m[:, 0], m[:, 1], m[:, 2], m[:, 3].to(torch.int64)
    cx = rois[:, 0] * scale - 0.5
    cy = rois[:, 1] * scale - 0.5
    rw = rois[:, 2] * scale
    rh = rois[:, 3] * scale
    theta = rois[:, 4] * math.pi / 180.0
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    g_h = grid[:, 0].to(torch.float32)
    g_w = grid[:, 1].to(torch.float32)
    bin_h = rh / ph_n
    bin_w = rw / pw_n
    count = (g_h * g_w)[:, None, None]
    ph = torch.arange(ph_n, dtype=torch.float32, device=dev)
    pw = torch.arange(pw_n, dtype=torch.float32, device=dev)
    w_r = width.to(torch.int64)[:, None, None]
    b_r = base[:, None, None]
    h3, w3 = height[:, None, None], width[:, None, None]
    gmax_h, gmax_w = (int(v) for v in grid.max(dim=0).values.tolist())

    def col(t):
        return t[:, None, None]

    for iy in range(gmax_h):
        yy = (-rh[:, None] / 2.0 + ph[None, :] * bin_h[:, None]) + (
            (iy + 0.5) * bin_h / g_h
        )[:, None]  # (R, ph)
        for ix in range(gmax_w):
            xx = (-rw[:, None] / 2.0 + pw[None, :] * bin_w[:, None]) + (
                (ix + 0.5) * bin_w / g_w
            )[:, None]  # (R, pw)
            y = (yy[:, :, None] * col(cos_t) - xx[:, None, :] * col(sin_t)) + col(cy)
            x = (yy[:, :, None] * col(sin_t) + xx[:, None, :] * col(cos_t)) + col(cx)
            (yi, xi, yi1, xi1), ws = bilinear_plain(y, x, h3, w3, count)
            on = col((iy < grid[:, 0]) & (ix < grid[:, 1]))
            ws = [torch.where(on, w, torch.zeros_like(w)) for w in ws]
            idx = [b_r + a * w_r + b for a, b in ((yi, xi), (yi, xi1), (yi1, xi), (yi1, xi1))]
            yield idx, ws


def sample_grid_plain(
    image_rows: torch.Tensor,
    meta: torch.Tensor,
    rois: torch.Tensor,
    levels: torch.Tensor,
    grid: torch.Tensor,
    output_size,
    normalize=None,
) -> torch.Tensor:
    """The arithmetic of both kernels in plain PyTorch: (R, ph, pw, C) f32.

    image_rows: (sum HW, C) rows of any dtype (taps are read in f32).
    normalize: optional (mean, std) per-channel f32 tensors; each sample's
    contribution becomes (sum w * v - sum w * mean) / std.
    """
    ph_n, pw_n = (int(v) for v in output_size)
    r = rois.shape[0]
    c = image_rows.shape[1]
    out = torch.zeros((r, ph_n, pw_n, c), dtype=torch.float32, device=image_rows.device)
    if r == 0:
        return out
    for idx, ws in plain_samples(meta, rois, levels, grid, output_size):
        taps = [image_rows[i.reshape(-1)].to(torch.float32).reshape(r, ph_n, pw_n, c) for i in idx]
        v = ((taps[0] * ws[0][..., None] + taps[1] * ws[1][..., None])
             + taps[2] * ws[2][..., None]) + taps[3] * ws[3][..., None]
        if normalize is not None:
            mean, std = normalize
            wsum = ((ws[0] + ws[1]) + ws[2]) + ws[3]
            v = (v - wsum[..., None] * mean) / std
        out = out + v
    return out


# ---------------------------------------------------------------------------
# glass_tpu's pooler entry points, each one launch of the packed kernel
# ---------------------------------------------------------------------------


def roi_align_rotated(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 0,
    max_sampling_ratio=4,
) -> torch.Tensor:
    """features (H, W, C) -> (R, ph, pw, C): single-level pooler."""
    pyr = pack_pyramid([features], [spatial_scale])
    rois = rois.to(torch.float32)
    levels = torch.zeros((rois.shape[0],), dtype=torch.int32, device=rois.device)
    if sampling_ratio > 0:
        grid = fixed_grid(rois.shape[0], sampling_ratio, rois.device)
    else:
        rh, rw = _scaled_extent(rois, pyr.meta, levels)
        grid = adaptive_grid(rh, rw, output_size, max_sampling_ratio)
    return roi_align_rotated_packed(pyr.flat, pyr.meta, rois, levels, grid, output_size)


def roi_align_rotated_adaptive(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size,
    spatial_scale: float = 1.0,
    max_sampling_ratio=4,
    bulk_sampling_ratio=2,
    large_roi_budget: int = 16,
) -> torch.Tensor:
    """Adaptive-grid pooler with glass_tpu's bulk grid + large-roi budget."""
    bh, bw = _grid_pair(bulk_sampling_ratio)
    mh, mw = _grid_pair(max_sampling_ratio)
    if bh >= mh and bw >= mw:
        return roi_align_rotated(
            features, rois, output_size, spatial_scale, 0, max_sampling_ratio
        )
    pyr = pack_pyramid([features], [spatial_scale])
    rois = rois.to(torch.float32)
    levels = torch.zeros((rois.shape[0],), dtype=torch.int32, device=rois.device)
    rh, rw = _scaled_extent(rois, pyr.meta, levels)
    grid = split_grid(rh, rw, output_size, (bh, bw), (mh, mw), large_roi_budget)
    return roi_align_rotated_packed(pyr.flat, pyr.meta, rois, levels, grid, output_size)


def assign_boxes_to_levels(
    rois: torch.Tensor,
    min_level: int,
    max_level: int,
    canonical_box_size: float = 224.0,
    canonical_level: int = 4,
) -> torch.Tensor:
    """FPN level assignment (detectron2 ``ROIPooler`` heuristic), in f32."""
    areas = torch.clamp(rois[..., 2] * rois[..., 3], min=1e-12)
    sqrt_area = torch.sqrt(areas)
    lvl = torch.floor(canonical_level + torch.log2(sqrt_area / canonical_box_size + 1e-8))
    return torch.clamp(lvl, min_level, max_level).to(torch.int32) - min_level


def multilevel_pool(
    pyr: PackedPyramid,
    min_level: int,
    rois: torch.Tensor,
    output_size,
    sampling_ratio: int = 0,
    max_sampling_ratio=4,
    bulk_sampling_ratio=0,
    large_roi_budget: int = 16,
    rois_per_image: int = 0,
) -> torch.Tensor:
    """detectron2 multi-level ``ROIPooler`` over an already packed pyramid.
    Over a batch's pyramid the rois are image-major blocks of
    ``rois_per_image``, each pooled from its own image (0: one image)."""
    rois = rois.to(torch.float32)
    n_levels = pyr.levels_per_image
    levels = assign_boxes_to_levels(rois, min_level, min_level + n_levels - 1)
    if rois_per_image:
        image = torch.arange(rois.shape[0], device=rois.device) // rois_per_image
        levels = levels + (image * n_levels).to(torch.int32)
    bh, bw = _grid_pair(bulk_sampling_ratio)
    mh, mw = _grid_pair(max_sampling_ratio)
    split = sampling_ratio == 0 and bh > 0 and bw > 0 and (bh < mh or bw < mw)
    if sampling_ratio > 0:
        grid = fixed_grid(rois.shape[0], sampling_ratio, rois.device)
    else:
        rh, rw = _scaled_extent(rois, pyr.meta, levels)
        if split:
            grid = split_grid(rh, rw, output_size, (bh, bw), (mh, mw), large_roi_budget,
                              rois_per_image)
        else:
            grid = adaptive_grid(rh, rw, output_size, (mh, mw))
    return roi_align_rotated_packed(pyr.flat, pyr.meta, rois, levels, grid, output_size)


def multilevel_roi_align_rotated_packed(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    output_size,
    strides: Sequence[int],
    sampling_ratio: int = 0,
    max_sampling_ratio=4,
    bulk_sampling_ratio=0,
    large_roi_budget: int = 16,
) -> torch.Tensor:
    """features: list of (H_l, W_l, C) maps ordered by level; strides per
    level.  Packs the pyramid and pools every roi from its assigned level."""
    min_level = int(strides[0]).bit_length() - 1
    pyr = pack_pyramid(features, [1.0 / s for s in strides])
    return multilevel_pool(
        pyr, min_level, rois, output_size, sampling_ratio, max_sampling_ratio,
        bulk_sampling_ratio, large_roi_budget,
    )
