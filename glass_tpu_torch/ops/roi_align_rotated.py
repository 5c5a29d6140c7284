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
kernel takes C a multiple of its 16-byte vector (4 f32, 8 bf16 or fp16 channels)
and 16-byte aligned features; the wrapper raises on anything else.

The pooler's feature gradient is kernel K1b (``csrc/roi_align_rotated_
backward.cu``, behind ``RoIAlignRotatedFunction``): three kernels a call
that pre-reduce each tile of bins' taps in shared memory and write the dense
gradient once in the features' dtype; ``bin_tile_footprints`` is the plain
version of how it sizes and places a tile's footprint.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Sequence

import torch

from . import _cuda

KERNEL = "roi_align_rotated"
BACKWARD_KERNEL = "roi_align_rotated_backward"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3}
VECTOR_BYTES = 16
# K1b's plan (csrc/roi_align_rotated_backward.cu): the map rows a bin
# tile's footprint may span (its shared index map), the rounding slack
# (pixels) the footprint's rectangle is widened by, the touched rows of 256
# channels the shared accumulator holds a round, the rounds before a tile
# takes the direct path, the samples a tile's table holds and the bins a
# tile may hold.
FOOTPRINT_ROWS = 2048
FOOTPRINT_SLACK = 1.0 / 16.0
SLOT_ROWS = 32
SLOT_ROUNDS = 6
TABLE_SAMPLES = 256
TILE_BINS = 16
UNIT_ROWS = 2  # packed rows one of K1b's mark flags covers
CPU_PLAN_SMS = 132  # the H100's multiprocessors: the plan a CPU call's stats describe


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
        raise TypeError(f"features must be float32, bfloat16 or float16, got {flat.dtype}")
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
        grad = roi_align_rotated_packed_backward(grad_out, meta, rois, levels, grid, ctx.n_rows,
                                                 out_dtype=ctx.dtype)
        return grad, None, None, None, None, None


def backward_tile(r: int, out_hw, sms: int) -> tuple:
    """K1b's tile of bins for ``r`` rois of a ``ph x pw`` pooler on a card
    of ``sms`` multiprocessors: at most 8 bin rows (the rows split evenly)
    by 2 columns, the rows halved while there are fewer tiles than four an
    SM.  The training shapes on an H100 (512, 128 and 8 rois): 7x2, 7x2 and
    1x2 bins."""
    ph, pw = (int(v) for v in out_hw)
    rows, cols = -(-ph // -(-ph // 8)), min(pw, 2)
    while rows > 1 and r * -(-ph // rows) * -(-pw // cols) < 4 * sms:
        rows = -(-rows // 2)
    return rows, cols


def backward_direct_tiles(meta, rois, levels, grid, out_hw, tile, footprint_rows=FOOTPRINT_ROWS,
                          slot_rows=SLOT_ROWS) -> int:
    """Plain count of the bin tiles that K1b sends to the direct path: a
    footprint above ``footprint_rows``, more samples than ``TABLE_SAMPLES``,
    or more touched rows than ``SLOT_ROUNDS`` rounds of ``slot_rows``."""
    r = rois.shape[0]
    if r == 0:
        return 0
    fp = bin_tile_footprints(meta, rois, levels, grid, out_hw, tile, footprint_rows)
    ph, pw = (int(v) for v in out_hw)
    th, tw = (int(v) for v in tile)
    tiles_w = -(-pw // tw)
    n_tiles = fp.y0.shape[1]
    dev = rois.device
    tile_of = ((torch.arange(ph, device=dev)[:, None] // th) * tiles_w
               + torch.arange(pw, device=dev)[None] // tw)
    bins = torch.bincount(tile_of.reshape(-1), minlength=n_tiles)
    samples = grid[:, :1].long() * grid[:, 1:].long() * bins[None]
    keys = []
    for idx, ws in plain_samples(meta, rois, levels, grid, out_hw):
        for i, w in zip(idx, ws):
            ri, a, b = torch.nonzero(w != 0, as_tuple=True)
            keys.append(torch.stack([ri * n_tiles + tile_of[a, b], i[ri, a, b]], 1))
    touched = torch.zeros(r * n_tiles, dtype=torch.int64, device=dev)
    if keys:
        pairs = torch.unique(torch.cat(keys), dim=0)
        touched = torch.bincount(pairs[:, 0], minlength=r * n_tiles)
    nonempty = (fp.y1 >= fp.y0) & (grid[:, :1] > 0) & (grid[:, 1:] > 0)
    direct = fp.direct | (samples > TABLE_SAMPLES) | (touched.reshape(r, n_tiles) > SLOT_ROUNDS * slot_rows)
    return int((direct & nonempty).sum())


_flags: dict = {}
_flags_lock = threading.Lock()


def _unit_flags(device: torch.device, n_units: int) -> torch.Tensor:
    """K1b's mark flags on the current stream: zero between calls (the
    finishing kernel clears what the marking kernel set), so they are
    allocated zeroed once per (device, stream) and size."""
    key = (device.index, _cuda.current_stream(device))
    with _flags_lock:
        flags = _flags.get(key)
        if flags is None or flags.numel() < n_units:
            flags = torch.zeros(max(n_units, 1), dtype=torch.int32, device=device)
            _flags[key] = flags
        return flags


def roi_align_rotated_packed_backward(grad_out, meta, rois, levels, grid, n_rows,
                                      out_dtype=torch.float32, return_stats=False):
    """The (n_rows, C) gradient of the packed features, in ``out_dtype``,
    for the upstream gradient (R, ph, pw, C) of ``roi_align_rotated_packed``.

    With ``return_stats`` also an int32 (2,) tensor on the gradient's device:
    the bin tiles that took the direct path, and the taps found outside their
    tile's footprint (0: the kernel drops such a tap).  Reading it syncs
    with the host; the kernels do not."""
    if out_dtype not in _DTYPES:
        raise TypeError(f"the output must be float32, bfloat16 or float16, got {out_dtype}")
    if grad_out.device.type == "cpu":
        grad = roi_align_rotated_packed_backward_plain(grad_out, meta, rois, levels, grid, n_rows)
        grad = grad.to(out_dtype)
        if not return_stats:
            return grad
        tile = backward_tile(rois.shape[0], grad_out.shape[1:3], CPU_PLAN_SMS)
        direct = backward_direct_tiles(meta, rois, levels, grid, grad_out.shape[1:3], tile)
        return grad, torch.tensor([direct, 0], dtype=torch.int32)
    if grad_out.device.type != "cuda":
        raise ValueError(f"unsupported device {grad_out.device}")
    if grad_out.dtype not in _DTYPES:
        raise TypeError(f"the gradient must be float32, bfloat16 or float16, got {grad_out.dtype}")
    r, ph, pw, c = grad_out.shape
    vec = max(vector_width(grad_out.dtype), vector_width(out_dtype))
    if c % vec:
        raise ValueError(f"the kernel needs C a multiple of {vec}, got C={c}")
    grad_out, meta, rois, levels, grid = (
        t.contiguous() for t in (grad_out, meta, rois, levels, grid)
    )
    if grad_out.data_ptr() % VECTOR_BYTES:
        raise ValueError("the kernel needs a 16-byte aligned gradient")
    dev, n_rows = grad_out.device, int(n_rows)
    out = torch.empty((n_rows, c), dtype=out_dtype, device=dev)
    acc = out if out_dtype == torch.float32 else torch.empty((n_rows, c), dtype=torch.float32, device=dev)
    # the marking kernel zeroes the stats when there is a roi
    stats = (torch.empty if r else torch.zeros)((2,), dtype=torch.int32, device=dev)
    flags = _unit_flags(dev, -(-n_rows // UNIT_ROWS))
    th, tw = backward_tile(r, (ph, pw), torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _load_backward()
    info = backward_unit_info(lib, r * -(-ph // th) * -(-pw // tw), dev)
    status = lib.glass_roi_align_rotated_backward(
        grad_out.data_ptr(), _DTYPES[grad_out.dtype], _DTYPES[out_dtype], c, rois.data_ptr(),
        meta.data_ptr(), levels.data_ptr(), grid.data_ptr(), r, ph, pw, th, tw, FOOTPRINT_ROWS,
        SLOT_ROWS, n_rows, acc.data_ptr(), out.data_ptr(), flags.data_ptr(), stats.data_ptr(),
        info.data_ptr(), _cuda.current_stream(dev),
    )
    _cuda.check_status(BACKWARD_KERNEL, status)
    _cuda.count(BACKWARD_KERNEL)
    return (out, stats) if return_stats else out


def _load_backward():
    lib = _cuda.load(BACKWARD_KERNEL)
    fn = lib.glass_roi_align_rotated_backward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_longlong, p, p, p, p, p, p]
        fn.restype = i
        lib.glass_roi_align_rotated_backward_unit_bytes.restype = i
    return lib


def backward_unit_info(lib, units: int, device) -> torch.Tensor:
    """Scratch for K1b's per-(roi, tile) records (the frame and footprint
    the marking kernel hands the scatter kernel)."""
    unit_bytes = lib.glass_roi_align_rotated_backward_unit_bytes()
    return torch.empty((max(units, 1) * unit_bytes,), dtype=torch.uint8, device=device)


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
    _cuda.count(KERNEL)
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


class TileFootprints(NamedTuple):
    """Per (roi, bin tile), tile-major within a roi: the level's first
    packed row and width, the inclusive map rows ``y0..y1`` and columns
    ``x0..x1`` that every tap of the tile's samples lies in (``y1 < y0``:
    the tile has no tap), and whether the footprint exceeds the kernel's
    shared-memory capacity (the tile then takes the direct path)."""

    base: torch.Tensor
    width: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor
    x0: torch.Tensor
    x1: torch.Tensor
    direct: torch.Tensor


def bin_tile_footprints(meta, rois, levels, grid, out_hw, tile, capacity=None) -> TileFootprints:
    """Plain version of K1b's ``tile_footprint`` (csrc/roi_align_rotated_
    backward.cu): the bounding rectangle, on the roi's level, of the bin
    tile's rotated extent, widened by ``FOOTPRINT_SLACK`` for rounding, plus
    the one-pixel tap reach, clamped to the map.  ``tile`` is (bin rows, bin
    columns); tiles run row-major over the ``ph x pw`` bins, the last ones
    cut at the edge.  Returns (R, tiles) tensors."""
    capacity = FOOTPRINT_ROWS if capacity is None else capacity
    ph_n, pw_n = (int(v) for v in out_hw)
    th_n, tw_n = (int(v) for v in tile)
    m = meta[levels.long()]
    scale, height, width, base = m[:, 0], m[:, 1], m[:, 2], m[:, 3].to(torch.int64)
    cx = rois[:, 0] * scale - 0.5
    cy = rois[:, 1] * scale - 0.5
    rw = rois[:, 2] * scale
    rh = rois[:, 3] * scale
    theta = rois[:, 4] * math.pi / 180.0
    cos_t, sin_t = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    bin_h, bin_w = (rh / ph_n)[:, None], (rw / pw_n)[:, None]
    h0 = torch.arange(0, ph_n, th_n, dtype=torch.float32, device=rois.device)
    w0 = torch.arange(0, pw_n, tw_n, dtype=torch.float32, device=rois.device)
    h1 = torch.clamp(h0 + th_n, max=ph_n)
    w1 = torch.clamp(w0 + tw_n, max=pw_n)
    # tile-major (tile row, tile column) pairs
    h0, h1 = h0.repeat_interleave(w0.numel()), h1.repeat_interleave(w0.numel())
    w0, w1 = w0.repeat(len(h1) // w0.numel()), w1.repeat(len(h1) // w1.numel())
    ya = (-rh[:, None] / 2.0 + h0[None] * bin_h)
    yb = (-rh[:, None] / 2.0 + h1[None] * bin_h)
    xa = (-rw[:, None] / 2.0 + w0[None] * bin_w)
    xb = (-rw[:, None] / 2.0 + w1[None] * bin_w)
    yc_lo, yc_hi = torch.minimum(ya * cos_t, yb * cos_t), torch.maximum(ya * cos_t, yb * cos_t)
    xs_lo, xs_hi = torch.minimum(xa * sin_t, xb * sin_t), torch.maximum(xa * sin_t, xb * sin_t)
    ys_lo, ys_hi = torch.minimum(ya * sin_t, yb * sin_t), torch.maximum(ya * sin_t, yb * sin_t)
    xc_lo, xc_hi = torch.minimum(xa * cos_t, xb * cos_t), torch.maximum(xa * cos_t, xb * cos_t)
    y_lo = (yc_lo - xs_hi) + cy[:, None] - FOOTPRINT_SLACK
    y_hi = (yc_hi - xs_lo) + cy[:, None] + FOOTPRINT_SLACK
    x_lo = (ys_lo + xc_lo) + cx[:, None] - FOOTPRINT_SLACK
    x_hi = (ys_hi + xc_hi) + cx[:, None] + FOOTPRINT_SLACK
    hf, wf = height[:, None], width[:, None]
    y0 = torch.minimum(torch.clamp(torch.floor(y_lo), min=0.0), hf - 1.0)
    y1 = torch.minimum(torch.clamp(torch.floor(y_hi) + 1.0, min=0.0), hf - 1.0)
    x0 = torch.minimum(torch.clamp(torch.floor(x_lo), min=0.0), wf - 1.0)
    x1 = torch.minimum(torch.clamp(torch.floor(x_hi) + 1.0, min=0.0), wf - 1.0)
    # every sample outside [-1, H] x [-1, W], or an empty grid: no tap
    empty = (y_hi < -1.0) | (y_lo > hf) | (x_hi < -1.0) | (x_lo > wf)
    empty = empty | ((grid[:, 0] <= 0) | (grid[:, 1] <= 0))[:, None]
    y0, y1, x0, x1 = (t.to(torch.int64) for t in (y0, y1, x0, x1))
    y1 = torch.where(empty, y0 - 1, y1)
    rows = (y1 - y0 + 1) * (x1 - x0 + 1)
    return TileFootprints(base[:, None].expand_as(y0), width.to(torch.int64)[:, None].expand_as(y0),
                          y0, y1, x0, x1, rows > capacity)


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
