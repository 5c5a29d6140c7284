"""Rotated RoIAlign (detectron2 ``ROIAlignRotated`` forward) over
channels-last feature maps: kernel K1 and its plain PyTorch version.

Counterpart of ``glass_tpu/ops/roi_align_rotated.py`` and of the Pallas
kernel ``glass_tpu/ops/pallas_roi_align.py``.  Semantics:

* rois are ``(cx, cy, w, h, angle_deg)``, scaled by the level's spatial
  scale and shifted by the aligned half-pixel offset,
* each roi is cut into ``ph x pw`` bins, each sampled on a ``g_h x g_w``
  grid: a fixed ``sampling_ratio``, or adaptive ``ceil(extent / pooled)``
  capped at ``max_sampling_ratio``,
* bilinear taps are averaged; a sample outside ``[-1, H] x [-1, W]`` adds
  zero.

Every pooler of the model is one call of ``roi_align_rotated_packed``: the
level maps are concatenated row-wise into one ``(sum HW, C)`` buffer with a
per-level ``(scale, H, W, row offset)`` table, each roi names its level,
and each roi carries its own ``(g_h, g_w)`` sampling grid.  The grid table
is where glass_tpu's static-shape realisations of the adaptive grid are
reproduced exactly: the bulk grid for every roi plus the full grid for the
first ``large_roi_budget`` rois that need it (rois beyond the budget keep
the bulk grid).  One launch then gives glass_tpu's result, overflow
included, up to the ~1e-4 FMA difference between its split and monolithic
passes that ``roi_align_rotated_adaptive`` documents.

On a CUDA tensor the wrapper launches the kernel (``csrc/
roi_align_rotated.cu``) or raises; on a CPU tensor it runs the plain
version, which repeats the kernel's arithmetic in the same order.  The
kernel takes C a multiple of its 16-byte vector (4 f32, 8 bf16 channels)
and 16-byte aligned features; the wrapper raises on anything else.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import torch

from . import _cuda

KERNEL = "roi_align_rotated"
BACKWARD_KERNEL = "roi_align_rotated_backward"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16


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


def _check(flat, meta, rois, levels, grid):
    if flat.dim() != 2 or meta.dim() != 2 or meta.shape[1] != 4:
        raise ValueError("expected flat (N, C) features and a (L, 4) level table")
    if rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"rois must be (R, 5), got {tuple(rois.shape)}")
    r = rois.shape[0]
    if levels.shape != (r,) or grid.shape != (r, 2):
        raise ValueError("levels must be (R,) and grid (R, 2)")
    if flat.dtype not in _DTYPES:
        raise TypeError(f"features must be float32 or bfloat16, got {flat.dtype}")
    devs = {t.device for t in (flat, meta, rois, levels, grid)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must lie on one device, got {devs}")


def vector_width(dtype: torch.dtype) -> int:
    """Channels one 16-byte load of the kernel moves."""
    return VECTOR_BYTES // torch.empty((), dtype=dtype).element_size()


def _check_channels(flat: torch.Tensor) -> None:
    vec = vector_width(flat.dtype)
    if flat.shape[1] % vec:
        raise ValueError(f"the kernel needs C a multiple of {vec} for {flat.dtype}, got C={flat.shape[1]}")


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
    _check(flat, meta, rois, levels, grid)
    if torch.is_grad_enabled() and flat.requires_grad:
        return RoIAlignRotatedFunction.apply(flat, meta, rois, levels, grid, tuple(output_size))
    return _pool_forward(flat, meta, rois, levels, grid, output_size)


class RoIAlignRotatedFunction(torch.autograd.Function):
    """The packed pooler as an autograd function: forward K1, backward K1b
    (each, on a CPU tensor, its plain version)."""

    @staticmethod
    def forward(ctx, flat, meta, rois, levels, grid, output_size):
        ctx.save_for_backward(meta, rois, levels, grid)
        ctx.n_rows, ctx.dtype = flat.shape[0], flat.dtype
        return _pool_forward(flat, meta, rois, levels, grid, output_size)

    @staticmethod
    def backward(ctx, grad_out):
        meta, rois, levels, grid = ctx.saved_tensors
        grad = roi_align_rotated_packed_backward(grad_out, meta, rois, levels, grid, ctx.n_rows)
        return grad.to(ctx.dtype), None, None, None, None, None


def roi_align_rotated_packed_backward(grad_out, meta, rois, levels, grid, n_rows):
    """The (n_rows, C) f32 gradient of the packed features for the upstream
    gradient (R, ph, pw, C) of ``roi_align_rotated_packed``."""
    if grad_out.device.type == "cpu":
        return roi_align_rotated_packed_backward_plain(grad_out, meta, rois, levels, grid, n_rows)
    if grad_out.device.type != "cuda":
        raise ValueError(f"unsupported device {grad_out.device}")
    if grad_out.dtype not in _DTYPES:
        raise TypeError(f"the gradient must be float32 or bfloat16, got {grad_out.dtype}")
    r, ph, pw, c = grad_out.shape
    if c % vector_width(grad_out.dtype):
        raise ValueError(f"the kernel needs C a multiple of {vector_width(grad_out.dtype)}, got C={c}")
    grad_out, meta, rois, levels, grid = (
        t.contiguous() for t in (grad_out, meta, rois, levels, grid)
    )
    if grad_out.data_ptr() % VECTOR_BYTES:
        raise ValueError("the kernel needs a 16-byte aligned gradient")
    grad = torch.zeros((int(n_rows), c), dtype=torch.float32, device=grad_out.device)
    if r == 0:
        return grad
    lib = _load_backward()
    status = lib.glass_roi_align_rotated_backward(
        grad_out.data_ptr(), _DTYPES[grad_out.dtype], c, rois.data_ptr(), meta.data_ptr(),
        levels.data_ptr(), grid.data_ptr(), r, ph, pw, grad.data_ptr(),
        _cuda.current_stream(grad_out.device),
    )
    _cuda.check_status(BACKWARD_KERNEL, status)
    _cuda.LAUNCHES[BACKWARD_KERNEL] += 1
    return grad


def _load_backward():
    lib = _cuda.load(BACKWARD_KERNEL)
    fn = lib.glass_roi_align_rotated_backward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, p, p, i, i, i, p, p]
        fn.restype = i
    return lib


def _pool_forward(flat, meta, rois, levels, grid, output_size):
    if flat.device.type == "cpu":
        return roi_align_rotated_packed_plain(flat, meta, rois, levels, grid, output_size)
    _check_channels(flat)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    ph, pw = (int(v) for v in output_size)
    flat, meta, rois, levels, grid = (
        t.contiguous() for t in (flat, meta, rois, levels, grid)
    )
    if flat.data_ptr() % VECTOR_BYTES:
        raise ValueError("the kernel needs 16-byte aligned features")
    r, c = rois.shape[0], flat.shape[1]
    out = torch.empty((r, ph, pw, c), dtype=flat.dtype, device=flat.device)
    if r == 0:
        return out
    lib = _load()
    status = lib.glass_roi_align_rotated(
        flat.data_ptr(), _DTYPES[flat.dtype], c, rois.data_ptr(), meta.data_ptr(),
        levels.data_ptr(), grid.data_ptr(), r, ph, pw, out.data_ptr(),
        _cuda.current_stream(flat.device),
    )
    _cuda.check_status(KERNEL, status)
    _cuda.LAUNCHES[KERNEL] += 1
    return out


def _load():
    lib = _cuda.load(KERNEL)
    fn = lib.glass_roi_align_rotated
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, p, p, i, i, i, p, p]
        fn.restype = i
    return lib


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


def roi_align_rotated_packed_plain(flat, meta, rois, levels, grid, output_size):
    """Plain PyTorch version of K1: f32 accumulation, output in flat.dtype."""
    return sample_grid_plain(flat, meta, rois, levels, grid, output_size).to(flat.dtype)


def roi_align_rotated_packed_backward_plain(grad_out, meta, rois, levels, grid, n_rows):
    """Plain PyTorch version of K1b: the (n_rows, C) f32 gradient of the
    packed features, every sample's ``w * grad_out`` added into its four tap
    rows with ``index_add_``, in the order of ``sample_grid_plain``."""
    r, c = grad_out.shape[0], grad_out.shape[-1]
    grad = torch.zeros((int(n_rows), c), dtype=torch.float32, device=grad_out.device)
    if r == 0:
        return grad
    g = grad_out.to(torch.float32)
    for idx, ws in plain_samples(meta, rois, levels, grid, grad_out.shape[1:3]):
        for i, w in zip(idx, ws):
            grad.index_add_(0, i.reshape(-1), (w[..., None] * g).reshape(-1, c))
    return grad


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
