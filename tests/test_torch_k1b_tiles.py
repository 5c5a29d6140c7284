"""K1b's plan on the CPU: every tap inside its bin tile's footprint, the
direct-path flag, the launch split, and the ``out_dtype`` contract.

K1b (``glass_tpu_torch/csrc/roi_align_rotated_backward.cu``) adds each tile
of bins' taps into a shared-memory tile of the tile's footprint rows, so a
tap outside the footprint would be lost (the kernel counts and drops it).
``bin_tile_footprints`` is the footprint arithmetic of the kernel in plain
torch; here every tap of nonzero weight of ``plain_samples`` (the kernels'
samples) must lie inside its tile's footprint, for the box (7x7, sampling
ratio 2), mask (14x14, split grid) and recognizer (8x32, one level, split
grid) poolers, over random rotated words, border-straddling rois, sub-pixel
rois, rois on every level and rois whose footprint exceeds the shared tile
(flagged for the direct path).  The gradient in the features' dtype is the
f32 gradient rounded once, and the bf16 autograd gradient is glass_tpu's
VJP rounded to bf16 within one bf16 ulp (the two f32 sums add in another
order, so their roundings may differ by one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glass_tpu.models.pooler_pad import feat_pad_v2_boxes as j_pad_boxes, feat_pad_v2_mask as j_pad_mask
from glass_tpu.ops.roi_align_rotated import multilevel_roi_align_rotated_packed as j_multilevel
from glass_tpu.ops.roi_align_rotated import roi_align_rotated_adaptive as j_adaptive

from glass_tpu_torch.models.pooler_pad import feat_pad_v2_boxes, feat_pad_v2_mask
from glass_tpu_torch.ops import roi_align_rotated as ra

torch.set_num_threads(2)
BUCKET = (384, 640)
STRIDES = (4, 8, 16, 32, 64)
# (name, output, sampling ratio, bulk grid, one level)
POOLERS = [
    ("box", (7, 7), 2, 2, False),
    ("mask", (14, 14), 0, (1, 2), False),
    ("recognizer", (8, 32), 0, (2, 1), True),
]


def _words(rng, n, h, w):
    return np.stack([rng.uniform(-20, w + 20, n), rng.uniform(-20, h + 20, n),
                     np.exp(rng.uniform(np.log(12), np.log(500), n)),
                     np.exp(rng.uniform(np.log(8), np.log(80), n)),
                     rng.uniform(-90, 90, n)], 1)


def _border(rng, n, h, w):
    return np.stack([rng.uniform(-24, w + 24, n), rng.uniform(-24, h + 24, n),
                     rng.uniform(16, w * 0.6, n), rng.uniform(12, h * 0.4, n),
                     rng.uniform(-180, 180, n)], 1)


def _subpixel(rng, n, h, w):
    # centres on and just off pixel corners and centres, extents under a pixel of P2
    cx = rng.randint(0, w // 4, n) * 4.0 + rng.choice([0.0, 1e-3, 2.0, 1.999], n)
    cy = rng.randint(0, h // 4, n) * 4.0 + rng.choice([0.0, 1e-3, 2.0, 3.999], n)
    return np.stack([cx, cy, rng.uniform(0.05, 3.0, n), rng.uniform(0.05, 3.0, n),
                     rng.uniform(-180, 180, n)], 1)


def _levels(rng, n, h, w):
    # sqrt(area) of 224 * 2^(l - 4) * 1.4 lands on level l (2..6), aspect 1-4
    lvl = np.arange(n) % 5 + 2
    side = 224.0 * 2.0 ** (lvl - 4) * 1.4
    aspect = rng.uniform(1, 4, n)
    return np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n), side * np.sqrt(aspect),
                     side / np.sqrt(aspect), rng.uniform(-90, 90, n)], 1)


def _oversize(rng, n, h, w):
    # long thin rotated words that stay on P2 (sqrt(area) under 112), and
    # image-sized rois
    k = n // 2
    thin = np.stack([rng.uniform(w * 0.3, w * 0.7, k), rng.uniform(h * 0.3, h * 0.7, k),
                     np.full(k, 6000.0), np.full(k, 2.0), rng.uniform(30, 60, k)], 1)
    huge = np.stack([rng.uniform(0, w, n - k), rng.uniform(0, h, n - k),
                     rng.uniform(3600, 4200, n - k), rng.uniform(2000, 3200, n - k),
                     rng.uniform(-30, 30, n - k)], 1)
    return np.concatenate([thin, huge])


def _words_featpad(rng, n, h, w):
    # FeatPadV2's recognizer pool boxes: words, half of them narrower than
    # the 8x32 aspect and widened to it (footprints up to 4x wider)
    words = _words(rng, n, h, w)
    words[: n // 2, 2] = words[: n // 2, 3] * rng.uniform(0.25, 3.0, n // 2)
    return feat_pad_v2_boxes(torch.from_numpy(words), (8, 32))[0].numpy()


# each set's seed is its index in sorted(ROI_SETS): a new set sorts last
ROI_SETS = {"words": _words, "border": _border, "subpixel": _subpixel, "levels": _levels,
            "oversize": _oversize, "words_featpad": _words_featpad}


def _pooler_inputs(name, rois):
    """meta, levels and per-roi grid as the model's pooler call builds them,
    for a BUCKET image (no features: the footprints need none)."""
    _, out_hw, sr, bulk, single = next(p for p in POOLERS if p[0] == name)
    h, w = BUCKET
    if single:
        meta = torch.tensor([[0.25, h // 4, w // 4, 0.0]])
        levels = torch.zeros(rois.shape[0], dtype=torch.int32)
    else:
        rows, off = [], 0
        for s in STRIDES:
            a, b = -(-h // s), -(-w // s)
            rows.append([1.0 / s, a, b, off])
            off += a * b
        meta = torch.tensor(rows, dtype=torch.float32)
        levels = ra.assign_boxes_to_levels(rois, 2, 6)
    if sr > 0:
        grid = ra.fixed_grid(rois.shape[0], sr, "cpu")
    else:
        rh, rw = ra._scaled_extent(rois, meta, levels)
        grid = ra.split_grid(rh, rw, out_hw, bulk, 4, 16)
    return meta, levels, grid, out_hw


def _check_taps_inside(meta, rois, levels, grid, out_hw, tile):
    """Asserts every tap of nonzero weight lies in its tile's footprint;
    returns the footprints and the number of taps checked."""
    fp = ra.bin_tile_footprints(meta, rois, levels, grid, out_hw, tile)
    ph, pw = out_hw
    th, tw = tile
    tiles_w = -(-pw // tw)
    assert fp.y0.shape == (rois.shape[0], -(-ph // th) * tiles_w)
    tile_of = (torch.arange(ph)[:, None] // th) * tiles_w + torch.arange(pw)[None] // tw
    m = meta[levels.long()]
    base, width, height = m[:, 3].long(), m[:, 2].long(), m[:, 1].long()
    nonempty = fp.y1 >= fp.y0
    assert (fp.y0[nonempty] >= 0).all() and (fp.x0[nonempty] >= 0).all()
    assert (fp.y1 < height[:, None]).all() and (fp.x1 < width[:, None]).all()
    checked = 0
    for idx, ws in ra.plain_samples(meta, rois, levels, grid, out_hw):
        for i, w in zip(idx, ws):
            r, a, b = torch.nonzero(w != 0, as_tuple=True)
            t = tile_of[a, b]
            row = i[r, a, b] - base[r]
            y, x = row // width[r], row % width[r]
            assert torch.equal(fp.base[r, t], base[r])
            inside = ((y >= fp.y0[r, t]) & (y <= fp.y1[r, t])
                      & (x >= fp.x0[r, t]) & (x <= fp.x1[r, t]))
            assert bool(inside.all()), (
                f"{int((~inside).sum())} taps outside their footprint, e.g. roi {int(r[~inside][0])}")
            checked += int(r.numel())
    return fp, checked


@pytest.mark.parametrize("roi_set", list(ROI_SETS))
@pytest.mark.parametrize("pooler", [p[0] for p in POOLERS])
def test_every_tap_lies_in_its_tile_footprint(pooler, roi_set):
    rng = np.random.RandomState(sorted(ROI_SETS).index(roi_set))
    rois = torch.from_numpy(ROI_SETS[roi_set](rng, 24, *BUCKET).astype(np.float32))
    meta, levels, grid, out_hw = _pooler_inputs(pooler, rois)
    if roi_set == "levels" and pooler != "recognizer":
        assert sorted(set(levels.tolist())) == [0, 1, 2, 3, 4]
    shipped = ra.backward_tile(rois.shape[0], out_hw, 132)
    for tile in {shipped, (1, 1), tuple(out_hw)}:
        fp, checked = _check_taps_inside(meta, rois, levels, grid, out_hw, tile)
        assert checked > 0
        rows = (fp.y1 - fp.y0 + 1).clamp(min=0) * (fp.x1 - fp.x0 + 1)
        assert torch.equal(fp.direct, rows > ra.FOOTPRINT_ROWS)
        if roi_set == "oversize" and tile == shipped:
            assert bool(fp.direct.any()), "no tile took the direct path"
        if roi_set == "subpixel":
            assert int(rows.max()) <= 16  # a sub-pixel tile's footprint is a few rows


def test_backward_tiles_and_launch_split():
    """7x2 bins for the box and mask poolers, and for the recognizer's 8
    rois the rows halved to 1x2, so that each pooler has at least four
    tiles an SM on a 132-SM card at the training shapes (512, 128 and 8
    rois)."""
    got = [ra.backward_tile(r, p[1], 132) for p, r in zip(POOLERS, (512, 128, 8))]
    assert got == [(7, 2), (7, 2), (1, 2)]
    for (name, out_hw, *_), r, (th, tw) in zip(POOLERS, (512, 128, 8), got):
        assert r * -(-out_hw[0] // th) * -(-out_hw[1] // tw) >= 4 * 132, name
        assert th * tw <= ra.TILE_BINS
    assert ra.backward_tile(1, (7, 7), 132) == (1, 2)  # as small as it goes


def _case(seed=0, c=16):
    rng = np.random.RandomState(seed)
    rois = torch.from_numpy(_border(rng, 12, *BUCKET).astype(np.float32))
    meta, levels, grid, out_hw = _pooler_inputs("box", rois)
    n_rows = int(meta[-1, 3] + meta[-1, 1] * meta[-1, 2])
    g = torch.from_numpy(rng.randn(rois.shape[0], *out_hw, c).astype(np.float32))
    return g, meta, rois, levels, grid, n_rows


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_out_dtype_is_the_f32_gradient_rounded_once(grad_dtype):
    g, meta, rois, levels, grid, n_rows = _case()
    g = g.to(grad_dtype)
    f32 = ra.roi_align_rotated_packed_backward_plain(g, meta, rois, levels, grid, n_rows)
    default = ra.roi_align_rotated_packed_backward(g, meta, rois, levels, grid, n_rows)
    assert default.dtype == torch.float32 and torch.equal(default, f32)
    for out_dtype in (torch.bfloat16, torch.float16):
        low = ra.roi_align_rotated_packed_backward(g, meta, rois, levels, grid, n_rows,
                                                   out_dtype=out_dtype)
        assert low.dtype == out_dtype and torch.equal(low, f32.to(out_dtype))
    with pytest.raises(TypeError):
        ra.roi_align_rotated_packed_backward(g, meta, rois, levels, grid, n_rows,
                                             out_dtype=torch.float64)


def test_stats_count_the_direct_tiles():
    rng = np.random.RandomState(5)
    rois = torch.from_numpy(_oversize(rng, 6, *BUCKET).astype(np.float32))
    meta, levels, grid, out_hw = _pooler_inputs("recognizer", rois)
    g = torch.from_numpy(rng.randn(rois.shape[0], *out_hw, 8).astype(np.float32))
    n_rows = int(meta[0, 1] * meta[0, 2])
    grad, stats = ra.roi_align_rotated_packed_backward(g, meta, rois, levels, grid, n_rows,
                                                       return_stats=True)
    tile = ra.backward_tile(rois.shape[0], out_hw, ra.CPU_PLAN_SMS)
    want = int(ra.bin_tile_footprints(meta, rois, levels, grid, out_hw, tile).direct.sum())
    assert want > 0
    assert stats.tolist()[1] == 0
    # the footprints above FOOTPRINT_ROWS, and tiles of too many samples or
    # touched rows
    assert stats.tolist()[0] >= want
    assert stats.tolist()[0] == ra.backward_direct_tiles(meta, rois, levels, grid, out_hw, tile)
    assert torch.equal(grad, ra.roi_align_rotated_packed_backward_plain(g, meta, rois, levels, grid,
                                                                        n_rows))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def test_bf16_autograd_gradient_is_the_jax_vjp_rounded():
    """Features in bf16: RoIAlignRotatedFunction's gradient comes back in
    bf16 and equals glass_tpu's f32 VJP (same bf16-exact features and
    cotangent) rounded to bf16, within one bf16 ulp."""
    rng = np.random.RandomState(6)
    h, w, c = 64, 80, 8
    shapes, strides = [(h // 4, w // 4, c), (h // 8, w // 8, c), (h // 16, w // 16, c)], [4, 8, 16]
    feats = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16) for s in shapes]
    rois = _border(rng, 10, h, w).astype(np.float32)
    rois[:4, 2:4] *= 3.0
    out_hw = (3, 3)
    ct = torch.from_numpy(rng.randn(10, *out_hw, c).astype(np.float32)).to(torch.bfloat16)

    tf = [f.clone().requires_grad_(True) for f in feats]
    got = ra.multilevel_roi_align_rotated_packed(tf, torch.from_numpy(rois), out_hw, strides, 2)
    assert got.dtype == torch.bfloat16
    got.backward(ct)

    def jfn(fs):
        return j_multilevel(fs, jnp.asarray(rois), out_hw, strides, sampling_ratio=2)

    _, vjp = jax.vjp(jfn, [jnp.asarray(f.float().numpy()) for f in feats])
    want = vjp(jnp.asarray(ct.float().numpy()))[0]
    for t, wg in zip(tf, want):
        assert t.grad.dtype == torch.bfloat16
        wg = np.asarray(wg)
        err = np.abs(t.grad.float().numpy() - wg)
        # f32 reordering (1e-5 of O(1) sums) plus one rounding to bf16
        assert (err <= _bf16_ulp(wg) + 1e-5).all(), float(err.max())


def test_featpad_v2_gradient_is_the_jax_vjp_and_ignores_the_padding():
    """The recognizer's pool on FeatPadV2's widened rois, then the padding
    mask: the feature gradient (K1b's plain version through the pooler's
    autograd function) equals glass_tpu's VJP of the same two steps
    (1e-4 abs, tests/test_torch_roi_align_grad.py's bound), and an upstream
    gradient on the padding columns alone gives exactly zero."""
    rng = np.random.RandomState(7)
    h, w, c = 96, 160, 8
    feat = rng.randn(h // 4, w // 4, c).astype(np.float32)
    words = _words(rng, 12, h, w).astype(np.float32)
    words[:8, 2] = words[:8, 3] * rng.uniform(0.25, 3.0, 8)
    words = torch.from_numpy(words)
    boxes, ratio = feat_pad_v2_boxes(words, (8, 32))
    assert int((ratio > 1).sum()) >= 6
    ct = rng.randn(12, 8, 32, c).astype(np.float32)

    def pool(f, b):
        return ra.roi_align_rotated_adaptive(f, b, (8, 32), 0.25, 4, (2, 1), 16)

    def jfn(f):
        b, r = j_pad_boxes(jnp.asarray(words.numpy()), (8, 32))
        return j_pad_mask(j_adaptive(f, b, (8, 32), spatial_scale=0.25, max_sampling_ratio=4,
                                     bulk_sampling_ratio=(2, 1), large_roi_budget=16), r)

    want, vjp = jax.vjp(jfn, jnp.asarray(feat))
    tf = torch.from_numpy(feat).requires_grad_(True)
    got = feat_pad_v2_mask(pool(tf, boxes), ratio)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), atol=1e-4)

    padding = feat_pad_v2_mask(torch.ones(12, 8, 32, c), ratio) == 0
    assert bool(padding.any())
    tf.grad = None
    feat_pad_v2_mask(pool(tf, boxes), ratio).backward(torch.from_numpy(ct) * padding)
    assert not tf.grad.any()
