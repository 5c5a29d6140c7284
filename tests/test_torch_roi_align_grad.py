"""The gradient of glass_tpu_torch's rotated RoIAlign (K1b's plain version,
through the pooler's autograd function) against glass_tpu's autodiff.

glass_tpu gets the pooler's feature gradient from XLA autodiff of its
packed gather (``jax.vjp`` here); the port's ``RoIAlignRotatedFunction``
runs K1's forward and, on a CPU tensor, ``roi_align_rotated_packed_
backward_plain`` (index_add_ of every sample's weighted taps).  Rois
straddle the map borders (the clamped taps of ``tests/
test_quad_tap_grad.py``'s ``_boundary_rois``).  f32 throughout; tolerance
1e-4 abs on outputs and gradients of O(1) (glass_tpu's own grad tests'
bound: the two sides add the same terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glass_tpu.ops.roi_align_rotated import multilevel_roi_align_rotated_packed as j_multilevel
from glass_tpu.ops.roi_align_rotated import roi_align_rotated_adaptive as j_adaptive

from glass_tpu_torch.ops import roi_align_rotated as ra

torch.set_num_threads(2)
C = 8


def _boundary_rois(h, w, n, rng):
    return np.stack([
        rng.uniform(-6, w + 6, n),
        rng.uniform(-6, h + 6, n),
        rng.uniform(4, w * 1.4, n),
        rng.uniform(3, h * 0.8, n),
        rng.uniform(-180, 180, n),
    ], axis=1).astype(np.float32)


def _vjp(fn, primals, ct):
    out, vjp = jax.vjp(fn, primals)
    return np.asarray(out), vjp(jnp.asarray(ct))[0]


# (name, output, sampling ratio, bulk grid, budget): the box pooler's fixed
# grid, and the mask pooler's split grid with a budget small enough that
# large rois overflow it
MULTILEVEL = [
    ("box", (3, 3), 2, 2, 16),
    ("mask split grid", (4, 4), 0, (1, 2), 2),
]


@pytest.mark.parametrize("name,out_hw,sr,bulk,budget", MULTILEVEL, ids=[m[0] for m in MULTILEVEL])
def test_multilevel_grad_matches_jax_vjp(name, out_hw, sr, bulk, budget):
    rng = np.random.RandomState(0)
    shapes, strides = [(16, 20, C), (8, 10, C), (4, 5, C)], [4, 8, 16]
    feats = [rng.randn(*s).astype(np.float32) for s in shapes]
    rois = _boundary_rois(64, 80, 10, rng)
    rois[:4, 2:4] *= 3.0  # large rois: finer grids, higher levels
    ct = rng.randn(10, *out_hw, C).astype(np.float32)

    def jfn(fs):
        return j_multilevel(fs, jnp.asarray(rois), out_hw, strides, sampling_ratio=sr,
                            max_sampling_ratio=4, bulk_sampling_ratio=bulk, large_roi_budget=budget)

    want, want_g = _vjp(jfn, [jnp.asarray(f) for f in feats], ct)
    tf = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    got = ra.multilevel_roi_align_rotated_packed(tf, torch.from_numpy(rois), out_hw, strides, sr, 4,
                                                 bulk, budget)
    assert type(got.grad_fn).__name__.startswith("RoIAlignRotatedFunction")
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)
    for t, w in zip(tf, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4)


def test_adaptive_grad_matches_jax_vjp():
    """The recognizer's 8x32-style pool: (2, 1) bulk grid + a budget of 2."""
    rng = np.random.RandomState(1)
    feat = rng.randn(20, 24, C).astype(np.float32)
    rois = _boundary_rois(80, 96, 7, rng)
    rois[:3, 2] *= 4.0
    ct = rng.randn(7, 4, 8, C).astype(np.float32)

    def jfn(f):
        return j_adaptive(f, jnp.asarray(rois), (4, 8), spatial_scale=0.25, max_sampling_ratio=4,
                          bulk_sampling_ratio=(2, 1), large_roi_budget=2)

    want, want_g = _vjp(jfn, jnp.asarray(feat), ct)
    tf = torch.from_numpy(feat).requires_grad_(True)
    got = ra.roi_align_rotated_adaptive(tf, torch.from_numpy(rois), (4, 8), 0.25, 4, (2, 1), 2)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_g), atol=1e-4)


def test_backward_plain_is_the_transpose_of_the_forward():
    """<ct, K1(f)> == <K1b(ct), f> for the plain versions (the forward is
    linear in the features)."""
    rng = np.random.RandomState(2)
    maps = [torch.from_numpy(rng.randn(12, 14, C).astype(np.float32)),
            torch.from_numpy(rng.randn(6, 7, C).astype(np.float32))]
    pyr = ra.pack_pyramid(maps, [0.25, 0.125])
    rois = torch.from_numpy(_boundary_rois(48, 56, 6, rng))
    levels = torch.tensor([0, 1, 0, 1, 0, 1], dtype=torch.int32)
    grid = torch.tensor([[1, 2], [2, 2], [3, 1], [4, 4], [1, 1], [2, 3]], dtype=torch.int32)
    out = ra.roi_align_rotated_packed_plain(pyr.flat, pyr.meta, rois, levels, grid, (3, 5))
    ct = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    g = ra.roi_align_rotated_packed_backward_plain(ct, pyr.meta, rois, levels, grid, pyr.flat.shape[0])
    lhs = float((ct.double() * out.double()).sum())
    rhs = float((g.double() * pyr.flat.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))


def test_autograd_function_on_cpu_runs_the_plain_backward():
    rng = np.random.RandomState(3)
    flat = torch.from_numpy(rng.randn(30, C).astype(np.float32)).requires_grad_(True)
    meta = torch.tensor([[1.0, 5.0, 6.0, 0.0]])
    rois = torch.from_numpy(_boundary_rois(5, 6, 4, rng))
    levels = torch.zeros(4, dtype=torch.int32)
    grid = torch.full((4, 2), 2, dtype=torch.int32)
    out = ra.roi_align_rotated_packed(flat, meta, rois, levels, grid, (2, 2))
    ct = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    out.backward(ct)
    want = ra.roi_align_rotated_packed_backward_plain(ct, meta, rois, levels, grid, 30)
    assert torch.equal(flat.grad, want)
    # without a gradient the pooler is the plain forward, bit for bit
    with torch.no_grad():
        assert torch.equal(ra.roi_align_rotated_packed(flat, meta, rois, levels, grid, (2, 2)), out)


def test_backward_rejects_other_devices():
    g = torch.zeros((1, 2, 2, C), device="meta")
    with pytest.raises(ValueError):
        ra.roi_align_rotated_packed_backward(g, torch.zeros((1, 4)), torch.zeros((1, 5)),
                                             torch.zeros(1, dtype=torch.int32),
                                             torch.ones((1, 2), dtype=torch.int32), 4)


@pytest.mark.parametrize("pooler", ["box", "mask"])
def test_batch_packing_matches_per_image_calls(pooler):
    """One launch over a batch's pyramid (meta row per (image, level),
    image-major rois, a budget per image) equals per-image calls, forward
    and backward."""
    rng = np.random.RandomState(4)
    b, r, strides = 2, 6, [4, 8]
    shapes = [(16, 20), (8, 10)]
    maps = [torch.from_numpy(rng.randn(b, C, h, w).astype(np.float32))
            .contiguous(memory_format=torch.channels_last).requires_grad_(True) for h, w in shapes]
    rois = np.stack([_boundary_rois(64, 80, r, rng) for _ in range(b)])
    rois[0, :4, 2:4] *= 3.0  # image 0 overflows a budget of 2; image 1 has its own
    out_hw, sr, bulk = ((3, 3), 2, 2) if pooler == "box" else ((4, 4), 0, (1, 2))
    ct = torch.from_numpy(rng.randn(b * r, *out_hw, C).astype(np.float32))

    pyr = ra.pack_batch_pyramid([m.permute(0, 2, 3, 1) for m in maps], [1.0 / s for s in strides])
    got = ra.multilevel_pool(pyr, 2, torch.from_numpy(rois.reshape(-1, 5)), out_hw, sr, 4, bulk, 2,
                             rois_per_image=r)
    got.backward(ct)
    got_g = [m.grad.clone() for m in maps]
    for m in maps:
        m.grad = None
    want = []
    for i in range(b):
        p = ra.pack_pyramid([m[i].permute(1, 2, 0) for m in maps], [1.0 / s for s in strides])
        want.append(ra.multilevel_pool(p, 2, torch.from_numpy(rois[i]), out_hw, sr, 4, bulk, 2))
    want = torch.cat(want)
    want.backward(ct)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for g, m in zip(got_g, maps):
        torch.testing.assert_close(g, m.grad, rtol=0, atol=1e-6)


def test_single_level_batch_pyramid_is_a_view():
    x = torch.randn(2, C, 6, 5).contiguous(memory_format=torch.channels_last)
    pyr = ra.pack_batch_pyramid([x.permute(0, 2, 3, 1)], [0.25])
    assert pyr.flat.data_ptr() == x.data_ptr() and pyr.flat.shape == (60, C)
    np.testing.assert_array_equal(pyr.meta.numpy(), [[0.25, 6, 5, 0], [0.25, 6, 5, 30]])
