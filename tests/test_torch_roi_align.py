"""Kernel K1 (rotated RoIAlign) of glass_tpu_torch: its plain PyTorch version
against glass_tpu's poolers, the Pallas kernel (interpret mode) and the
published ROIAlignRotated spec vectors.

Tolerance 1e-4 abs, as glass_tpu's own parity tests use: both sides sum
the same f32 bilinear taps, in another order and with or without FMA
contraction of the sample coordinates.
"""

import importlib
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_golden_kernel_vectors import _spec_roi_align_rotated  # noqa: E402

from glass_tpu.ops.pallas_roi_align import roi_align_rotated_pallas  # noqa: E402
from glass_tpu_torch.ops import _cuda  # noqa: E402

J = importlib.import_module("glass_tpu.ops.roi_align_rotated")
T = importlib.import_module("glass_tpu_torch.ops.roi_align_rotated")

torch.set_num_threads(2)
TOL = 1e-4


def _word_rois(rng, n, h, w, big=1.0):
    """Rotated word-like rois, some hanging over the map edge."""
    return np.stack([
        rng.uniform(-10, w + 10, n),
        rng.uniform(-10, h + 10, n),
        rng.uniform(4, 160 * big, n),
        rng.uniform(3, 60 * big, n),
        rng.uniform(-180, 180, n),
    ], 1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_single_level_matches_glass_tpu(sampling_ratio):
    rng = np.random.RandomState(0)
    feat = rng.randn(40, 56, 16).astype(np.float32)
    rois = _word_rois(rng, 40, 160, 224)
    want = np.asarray(J.roi_align_rotated(jnp.asarray(feat), jnp.asarray(rois), (7, 7),
                                          spatial_scale=0.25, sampling_ratio=sampling_ratio))
    got = T.roi_align_rotated(_t(feat), _t(rois), (7, 7), 0.25, sampling_ratio).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_adaptive_with_budget_overflow_matches_glass_tpu():
    """The recognizer pool: bulk grid (2, 1), full grid 4 for the first 16
    large rois; more than 16 are large, so the overflow keeps the bulk grid."""
    rng = np.random.RandomState(1)
    feat = rng.randn(40, 56, 16).astype(np.float32)
    rois = _word_rois(rng, 48, 160, 224, big=2.0)
    g_w = np.ceil(rois[:, 2] * 0.25 / 32)
    g_h = np.ceil(rois[:, 3] * 0.25 / 8)
    assert ((g_h > 2) | (g_w > 1)).sum() > 16
    want = np.asarray(J.roi_align_rotated_adaptive(
        jnp.asarray(feat), jnp.asarray(rois), (8, 32), spatial_scale=0.25,
        max_sampling_ratio=4, bulk_sampling_ratio=(2, 1), large_roi_budget=16))
    got = T.roi_align_rotated_adaptive(_t(feat), _t(rois), (8, 32), 0.25, 4, (2, 1), 16).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("sampling_ratio,bulk", [(2, 2), (0, (1, 2)), (0, 0)])
def test_multilevel_packed_matches_glass_tpu(sampling_ratio, bulk):
    """Box pooler (sr 2), mask pooler (adaptive, bulk (1, 2) + budget) and
    the monolithic adaptive grid, over a five-level pyramid."""
    rng = np.random.RandomState(2)
    strides = [4, 8, 16, 32, 64]
    feats = [rng.randn(256 // s, 320 // s, 8).astype(np.float32) for s in strides]
    rois = _word_rois(rng, 48, 256, 320, big=3.0)
    want = np.asarray(J.multilevel_roi_align_rotated_packed(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), (14, 14), strides,
        sampling_ratio=sampling_ratio, max_sampling_ratio=4,
        bulk_sampling_ratio=bulk, large_roi_budget=16))
    got = T.multilevel_roi_align_rotated_packed(
        [_t(f) for f in feats], _t(rois), (14, 14), strides, sampling_ratio, 4, bulk, 16).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_assign_boxes_to_levels_matches_glass_tpu():
    rng = np.random.RandomState(3)
    rois = _word_rois(rng, 200, 800, 800, big=6.0)
    want = np.asarray(J.assign_boxes_to_levels(jnp.asarray(rois), 2, 6))
    got = T.assign_boxes_to_levels(_t(rois), 2, 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_split_grid_budget_takes_first_large_rois_by_index():
    rh = torch.tensor([8.0, 40.0, 8.0, 40.0, 40.0])  # ceil(/14): 1, 3, 1, 3, 3
    rw = torch.full((5,), 8.0)
    grid = T.split_grid(rh, rw, (14, 14), (1, 2), 4, large_roi_budget=2)
    assert grid.tolist() == [[1, 1], [3, 1], [1, 1], [3, 1], [1, 1]]


@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_matches_pallas_kernel_interpret(sampling_ratio):
    """The TPU kernel this one replaces, run in Pallas interpret mode."""
    rng = np.random.RandomState(4)
    feat = rng.randn(64, 128, 8).astype(np.float32)
    rois = np.array([
        [60.0, 40.0, 30.0, 14.0, 0.0],
        [60.0, 40.0, 30.0, 14.0, 30.0],
        [30.0, 30.0, 24.0, 10.0, -75.0],
        [100.0, 50.0, 18.0, 18.0, 120.0],
    ], np.float32)
    want = np.asarray(roi_align_rotated_pallas(
        jnp.asarray(feat), jnp.asarray(rois), (7, 7), spatial_scale=0.5,
        sampling_ratio=sampling_ratio, tile=(48, 48)))
    got = T.roi_align_rotated(_t(feat), _t(rois), (7, 7), 0.5, sampling_ratio).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("sampling_ratio", [1, 2])
def test_golden_spec_vectors(sampling_ratio):
    """The numpy transcription of d2's ROIAlignRotated spec
    (tests/test_golden_kernel_vectors.py)."""
    rng = np.random.RandomState(2)
    feat = rng.randn(24, 32, 5).astype(np.float32)
    rois = np.array([
        [16.0, 12.0, 14.0, 8.0, 0.0],
        [16.0, 12.0, 14.0, 8.0, 33.0],
        [10.0, 18.0, 20.0, 6.0, -75.0],
        [30.0, 4.0, 9.0, 9.0, 120.0],
        [2.0, 2.0, 6.0, 6.0, 45.0],
    ], np.float32)
    got = T.roi_align_rotated(_t(feat), _t(rois), (7, 7), 1.0, sampling_ratio).numpy()
    want = _spec_roi_align_rotated(feat, rois, (7, 7), 1.0, sampling_ratio)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_golden_spec_stride_and_dynamic_grid():
    rng = np.random.RandomState(4)
    feat = rng.randn(16, 16, 3).astype(np.float32)
    rois = np.array([[30.0, 30.0, 40.0, 24.0, 20.0], [28.0, 36.0, 56.0, 16.0, -10.0]], np.float32)
    got = T.roi_align_rotated(_t(feat), _t(rois), (4, 4), 0.25, 0, 4).numpy()
    want = _spec_roi_align_rotated(feat, rois, (4, 4), 0.25, 0)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_linear_ramp_closed_form():
    """Bilinear sampling reproduces an affine function exactly: each bin
    equals f at its mean sample point."""
    ys, xs = np.mgrid[0:32, 0:32]
    feat = (3.0 * xs + 2.0 * ys + 1.0)[..., None].astype(np.float32)
    cx, cy, w, h, a = 15.0, 14.0, 12.0, 6.0, 25.0
    got = T.roi_align_rotated(_t(feat), torch.tensor([[cx, cy, w, h, a]]), (4, 4), 1.0, 2)[0, ..., 0]
    th = np.deg2rad(a)
    for ph in range(4):
        for pw in range(4):
            yy = -h / 2 + (ph + 0.5) * h / 4
            xx = -w / 2 + (pw + 0.5) * w / 4
            y = yy * np.cos(th) - xx * np.sin(th) + cy - 0.5
            x = yy * np.sin(th) + xx * np.cos(th) + cx - 0.5
            assert abs(float(got[ph, pw]) - (3 * x + 2 * y + 1)) < 1e-3


def test_bfloat16_features_accumulate_in_float32():
    """bf16 maps: taps read as f32, summed in f32, one rounding at the end."""
    rng = np.random.RandomState(5)
    feat = torch.from_numpy(rng.randn(40, 56, 16).astype(np.float32)).to(torch.bfloat16)
    rois = _t(_word_rois(rng, 16, 160, 224))
    got = T.roi_align_rotated(feat, rois, (8, 32), 0.25, 0)
    ref = T.roi_align_rotated(feat.float(), rois, (8, 32), 0.25, 0)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.to(torch.bfloat16))


def test_cpu_tensors_take_the_plain_version():
    """The wrapper launches nothing for CPU tensors; it raises for other
    devices rather than falling back."""
    rng = np.random.RandomState(6)
    feat = _t(rng.randn(8, 8, 4).astype(np.float32))
    rois = torch.tensor([[4.0, 4.0, 3.0, 2.0, 10.0]])
    before = _cuda.LAUNCHES[T.KERNEL]
    T.roi_align_rotated(feat, rois, (2, 2), 1.0, 2)
    assert _cuda.LAUNCHES[T.KERNEL] == before
    meta = torch.tensor([[1.0, 8.0, 8.0, 0.0]], device="meta")
    with pytest.raises(ValueError):
        T.roi_align_rotated_packed(
            feat.reshape(64, 4).to("meta"), meta, rois.to("meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.full((1, 2), 2, dtype=torch.int32, device="meta"), (2, 2))
