"""Binary rotated mask windows: kernel K3 and its plain PyTorch version.

Each word's ``M x M`` mask probabilities are warped through the word's
inverse affine map into the word's window of the image (bilinear,
``BORDER_CONSTANT`` 0) and thresholded, exactly as ``cv2.warpAffine(mask,
forward, (w, h), flags=INTER_LINEAR) >= threshold`` does, in one of the two
float32 forms that OpenCV builds compute (``FORM_FLOAT``: OpenCV 5's
vectorised warp; ``FORM_FIXED``: OpenCV 4's 1/32-pixel remap tables; the
kernel's source spells out each).  ``postprocess/paste.py`` builds the
inputs, picks the form that the host's cv2 reproduces and follows the
contours of the windows.

Layout, shared by the kernel and the plain version: window ``i`` is
``geo[i] = (offset, w, h)``: ``w * h`` bytes, row-major, at ``offset`` (a
multiple of 16) in one flat output, zero-padded to 16 bytes.  A word is
flagged when one of its pixels lies within ``eps`` of the threshold (in
``FORM_FIXED`` only where that pixel's value carries a rounding error: an
exact value is the same in any implementation of the form), and each
window's foreground bounding box ``(x0, y0, x1, y1)``, inclusive, comes
back with it (``(INT_MAX, INT_MAX, -1, -1)`` for none).

Replaces no TPU kernel (glass_tpu pastes on the host); ``paste_binarize``
launches ``csrc/paste_masks_rotated.cu`` on the card, ``paste_binarize_plain``
repeats its arithmetic on the CPU: float32 fused multiply-adds are computed
exactly in float64 (``fma_f32``), so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda

KERNEL = "paste_masks_rotated"
FORM_FLOAT, FORM_FIXED = 0, 1
TILE = 4096       # pixels a block of the kernel pastes
SIMD_COLS = 16    # FORM_FLOAT: the columns of OpenCV's vector loop, per run of a row
MAX_MASK = 64
NO_FG = 2 ** 31 - 1  # a foreground box's x0 and y0 before any foreground pixel


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, the sum's rounding error comes from
    TwoSum, and a float64 sum that lands on a float32 midpoint is nudged
    the way the error points before it is rounded to float32."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    r64 = r.double()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.full_like(r, float("-inf")))
    other = torch.where(s > r64, up, down).double()
    tie = (s != r64) & ((r64 + other) * 0.5 == s) & (err != 0)
    nudged = torch.nextafter(s, torch.where(err > 0, torch.full_like(s, float("inf")),
                                            torch.full_like(s, float("-inf"))))
    return torch.where(tie, nudged.float(), r)


def _taps(mask: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    m = mask.shape[0]

    def tap(y, x):
        inside = (y >= 0) & (y < m) & (x >= 0) & (x < m)
        return torch.where(inside, mask[y.clamp(0, m - 1), x.clamp(0, m - 1)], mask.new_zeros(()))

    return tap(iy, ix), tap(iy, ix + 1), tap(iy + 1, ix), tap(iy + 1, ix + 1)


def warp_window_plain(mask: torch.Tensor, inverse, w: int, h: int, form: int, with_exact: bool = False):
    """(h, w) float32 values of one window: ``mask`` (M, M) float32,
    ``inverse`` the six float64 numbers of the word's inverse map.
    ``with_exact`` (``FORM_FIXED``): also whether each value's every step
    was exact."""
    ys = torch.arange(h, dtype=torch.float64)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float64)[None, :].expand(h, w)
    d = [float(v) for v in inverse]
    if form == FORM_FLOAT:
        m0, m1, m2, m3, m4, m5 = (torch.tensor(v, dtype=torch.float32) for v in d)
        fx, fy = xs.float(), ys.float()
        body = xs < (w // SIMD_COLS) * SIMD_COLS
        sx = torch.where(body, fma_f32(m0, fx, fy * m1 + m2), fma_f32(fx, m0, fy * m1) + m2)
        sy = torch.where(body, fma_f32(m3, fx, fy * m4 + m5), fma_f32(fx, m3, fy * m4) + m5)
        flx, fly = torch.floor(sx), torch.floor(sy)
        a, b = sx - flx, sy - fly
        p00, p01, p10, p11 = _taps(mask, fly.long(), flx.long())
        v0 = fma_f32(a, p01 - p00, p00)
        v1 = fma_f32(a, p11 - p10, p10)
        return fma_f32(b, v1 - v0, v0)
    if form != FORM_FIXED:
        raise ValueError(f"unknown form {form}")
    x0 = torch.round((d[1] * ys + d[2]) * 1024).long() + 16  # round half to even, as cvRound
    y0 = torch.round((d[4] * ys + d[5]) * 1024).long() + 16
    big_x = (x0 + torch.round(d[0] * xs * 1024).long()) >> 5
    big_y = (y0 + torch.round(d[3] * xs * 1024).long()) >> 5
    fx = (big_x & 31).float() * (1.0 / 32)
    fy = (big_y & 31).float() * (1.0 / 32)
    gx, gy = 1.0 - fx, 1.0 - fy
    p00, p01, p10, p11 = _taps(mask, big_y >> 5, big_x >> 5)
    q = [p00 * (gy * gx), p01 * (gy * fx), p10 * (fy * gx), p11 * (fy * fx)]
    s1 = q[0] + q[1]
    s2 = s1 + q[2]
    v = s2 + q[3]
    if not with_exact:
        return v
    # every float step equals the same step in double (exact there)
    exact = torch.ones_like(v, dtype=torch.bool)
    for prod, p, wt in zip(q, (p00, p01, p10, p11), (gy * gx, gy * fx, fy * gx, fy * fx)):
        exact &= prod.double() == p.double() * wt.double()
    for total, a, b in ((s1, q[0], q[1]), (s2, s1, q[2]), (v, s2, q[3])):
        exact &= total.double() == a.double() + b.double()
    return v, exact


def paste_binarize_plain(masks: torch.Tensor, maps: torch.Tensor, geo: torch.Tensor, form: int,
                         threshold: float = 0.5, eps: float = 0.0):
    """Plain PyTorch version of K3.  masks (N, M, M) float32, maps (N, 6)
    float64, geo (N, 3) int64 -> (the flat uint8 output, (N,) int32 flags,
    (N, 4) int32 foreground boxes)."""
    thr = torch.tensor(threshold, dtype=torch.float32)
    total = int((geo[:, 0] + (geo[:, 1] * geo[:, 2] + 15) // 16 * 16).max()) if len(geo) else 0
    out = torch.zeros(total, dtype=torch.uint8)
    flags = torch.zeros(len(geo), dtype=torch.int32)
    fg = torch.tensor([[NO_FG, NO_FG, -1, -1]] * len(geo), dtype=torch.int32).reshape(-1, 4)
    for i, (off, w, h) in enumerate(geo.tolist()):
        if form == FORM_FIXED:
            v, exact = warp_window_plain(masks[i].float(), maps[i], w, h, form, with_exact=True)
        else:
            v = warp_window_plain(masks[i].float(), maps[i], w, h, form)
            exact = torch.zeros_like(v, dtype=torch.bool)
        on = v >= thr
        out[off:off + w * h] = on.flatten().to(torch.uint8)
        flags[i] = int(bool((((v - thr).abs() <= eps) & ~exact).any()))
        ys, xs = torch.nonzero(on, as_tuple=True)
        if len(ys):
            fg[i] = torch.tensor([int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())])
    return out, flags, fg


def tile_table(geo: np.ndarray) -> np.ndarray:
    """(T, 2) int32 (word, first pixel) of every 4096-pixel tile of every
    window, in word order."""
    areas = geo[:, 1] * geo[:, 2]
    n = (areas + TILE - 1) // TILE
    word = np.repeat(np.arange(len(geo)), n)
    first = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    return np.stack([word, first * TILE], 1).astype(np.int32)


def paste_binarize(masks: torch.Tensor, maps: torch.Tensor, geo: torch.Tensor, tiles: torch.Tensor,
                   fg: torch.Tensor, form: int, threshold: float, eps: float, out: torch.Tensor,
                   flags: torch.Tensor, stream: torch.cuda.Stream) -> None:
    """K3: one launch on ``stream`` over ``tiles`` (``tile_table``).  masks
    (N, M, M) float32, maps (N, 6) float64, geo (N, 3) int64, tiles (T, 2)
    int32 and fg ((N, 4) int32, each row ``(NO_FG, NO_FG, -1, -1)``) lie on
    the card; ``out`` (uint8, large enough for every window) and ``flags``
    ((N,) int32, zeroed) are pinned host tensors that the kernel writes in
    place.  Returns before the kernel ends: wait on ``stream``."""
    n, m = masks.shape[0], masks.shape[-1]
    if masks.dtype != torch.float32 or masks.dim() != 3 or masks.shape[1] != m or not 0 < m <= MAX_MASK:
        raise ValueError(f"masks must be (N, M, M) float32 with M <= {MAX_MASK}, got {masks.dtype} "
                         f"{tuple(masks.shape)}")
    if (maps.dtype, tuple(maps.shape)) != (torch.float64, (n, 6)):
        raise ValueError(f"maps must be ({n}, 6) float64, got {maps.dtype} {tuple(maps.shape)}")
    if (geo.dtype, tuple(geo.shape)) != (torch.int64, (n, 3)):
        raise ValueError(f"geo must be ({n}, 3) int64, got {geo.dtype} {tuple(geo.shape)}")
    if tiles.dtype != torch.int32 or tiles.dim() != 2 or tiles.shape[1] != 2:
        raise ValueError(f"tiles must be (T, 2) int32, got {tiles.dtype} {tuple(tiles.shape)}")
    if (fg.dtype, tuple(fg.shape)) != (torch.int32, (n, 4)):
        raise ValueError(f"fg must be ({n}, 4) int32, got {fg.dtype} {tuple(fg.shape)}")
    if form not in (FORM_FLOAT, FORM_FIXED):
        raise ValueError(f"unknown form {form}")
    for t in (masks, maps, geo, tiles, fg):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("masks, maps, geo, tiles and fg must be contiguous tensors on the card")
    for t in (out, flags):
        if not t.is_pinned() or t.storage_offset() != 0:
            raise ValueError("out and flags must be whole pinned host tensors")
    if flags.dtype != torch.int32 or flags.numel() < n or out.dtype != torch.uint8:
        raise ValueError("out must be uint8 and flags int32 with a slot for every word")
    if tiles.shape[0] == 0:
        return
    lib = _load()
    status = lib.glass_paste_masks_rotated(
        masks.data_ptr(), m, maps.data_ptr(), geo.data_ptr(), tiles.data_ptr(), tiles.shape[0],
        form, float(np.float32(threshold)), float(np.float32(eps)), out.data_ptr(), flags.data_ptr(),
        fg.data_ptr(), stream.cuda_stream,
    )
    _cuda.check_status(KERNEL, status)
    _cuda.count(KERNEL)


def _load():
    lib = _cuda.load(KERNEL)
    fn = lib.glass_paste_masks_rotated
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, p, p, i, i, f, f, p, p, p, p]
        fn.restype = i
    return lib
