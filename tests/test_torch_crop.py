"""Kernel K2 (raw-image rotated crop) of glass_tpu_torch: its plain PyTorch
version against glass_tpu's Pallas crop kernel (interpret mode) and its
XLA ``roi_align_rotated`` on float and uint8 images, mirroring the cases of
tests/test_pallas_crop.py.

Tolerances: 1e-4 abs on [0, 1) float images, as test_pallas_crop.py uses
(sample positions factorised differently move bilinear weights by O(1e-5)).
For the uint8 fold the values are (raw - mean) / std of raw pixels 0-255:
the same relative 1e-4 of the raw range, 1e-4 * 255 / min(std) abs.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.ops.pallas_crop import crop_rois_pallas
from glass_tpu_torch.ops import _cuda
from glass_tpu_torch.ops.crop import KERNEL, crop_rois

J = importlib.import_module("glass_tpu.ops.roi_align_rotated")

torch.set_num_threads(2)
TOL = 1e-4
MEAN = np.array([103.53, 116.28, 123.675], np.float32)
STD = np.array([57.375, 57.12, 58.395], np.float32)


def _image(h=180, w=220, seed=0):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def _compare_pallas(image, rois):
    rois = np.asarray(rois, np.float32)
    want = np.asarray(crop_rois_pallas(jnp.asarray(image), jnp.asarray(rois), (128, 128),
                                       interpret=True))
    got = crop_rois(torch.from_numpy(image), torch.from_numpy(rois), (128, 128), 1).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_axis_aligned_and_cardinal_angles():
    _compare_pallas(_image(), [
        [60.0, 50.0, 40.0, 20.0, 0.0],
        [60.0, 50.0, 40.0, 20.0, 90.0],
        [110.0, 90.0, 30.0, 60.0, 180.0],
        [110.0, 90.0, 30.0, 60.0, -90.0],
    ])


def test_diagonal_angles():
    _compare_pallas(_image(), [
        [80.0, 70.0, 50.0, 18.0, 45.0],
        [80.0, 70.0, 50.0, 18.0, -45.0],
        [80.0, 70.0, 50.0, 18.0, 44.0],
        [80.0, 70.0, 50.0, 18.0, 46.0],
        [100.0, 90.0, 24.0, 64.0, 135.0],
        [100.0, 90.0, 24.0, 64.0, -135.0],
    ])


def test_random_geometry_sweep():
    rng = np.random.RandomState(7)
    n = 24
    rois = np.stack([rng.uniform(10, 210, n), rng.uniform(10, 170, n), rng.uniform(2, 90, n),
                     rng.uniform(2, 90, n), rng.uniform(-180, 180, n)], axis=1)
    _compare_pallas(_image(seed=3), rois)


def test_edge_overhang_and_clamping():
    _compare_pallas(_image(), [
        [4.0, 60.0, 40.0, 16.0, 30.0],
        [216.0, 60.0, 40.0, 16.0, -30.0],
        [100.0, 3.0, 50.0, 20.0, 10.0],
        [100.0, 177.0, 50.0, 20.0, 100.0],
        [1.0, 1.0, 30.0, 30.0, 45.0],
    ])


def test_large_rois_need_no_rescue():
    """Rois larger than the Pallas tile (which needed its XLA rescue loop)."""
    _compare_pallas(_image(), [
        [110.0, 90.0, 200.0, 60.0, 25.0],
        [110.0, 90.0, 150.0, 150.0, -60.0],
        [60.0, 50.0, 40.0, 20.0, 15.0],
    ])


def _rois(seed=11, n=20):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-10, 230, n), rng.uniform(-10, 190, n), rng.uniform(2, 400, n),
                     rng.uniform(2, 200, n), rng.uniform(-180, 180, n)], axis=1).astype(np.float32)


@pytest.mark.parametrize("sampling_ratio", [1, 2, 0])
def test_float_image_matches_roi_align_rotated(sampling_ratio):
    image, rois = _image(), _rois()
    want = np.asarray(J.roi_align_rotated(jnp.asarray(image), jnp.asarray(rois), (128, 128),
                                          spatial_scale=1.0, sampling_ratio=sampling_ratio,
                                          max_sampling_ratio=2))
    got = crop_rois(torch.from_numpy(image), torch.from_numpy(rois), (128, 128),
                    sampling_ratio, 2).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("sampling_ratio", [1, 2, 0])
def test_uint8_fold_matches_roi_align_rotated(sampling_ratio):
    """The eval upload path: crops of the normalized image computed from the
    raw uint8 pixels."""
    image = (_image(seed=4) * 255).astype(np.uint8)
    rois = _rois(seed=12)
    want = np.asarray(J.roi_align_rotated(
        jnp.asarray(image), jnp.asarray(rois), (128, 128), spatial_scale=1.0,
        sampling_ratio=sampling_ratio, max_sampling_ratio=2,
        normalize=(jnp.asarray(MEAN), jnp.asarray(STD))))
    got = crop_rois(torch.from_numpy(image), torch.from_numpy(rois), (128, 128), sampling_ratio, 2,
                    normalize=(MEAN, STD))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * 255 / STD.min())


def test_uint8_fold_equals_crop_of_normalized_image():
    image = (_image(seed=5) * 255).astype(np.uint8)
    rois = torch.from_numpy(_rois(seed=13))
    fold = crop_rois(torch.from_numpy(image), rois, (32, 32), 0, 2, normalize=(MEAN, STD))
    norm = torch.from_numpy((image.astype(np.float32) - MEAN) / STD)
    np.testing.assert_allclose(fold.numpy(), crop_rois(norm, rois, (32, 32), 0, 2).numpy(),
                               atol=TOL * 255 / STD.min())


def test_bfloat16_image_keeps_its_dtype_and_launches_nothing_on_cpu():
    image = torch.from_numpy(_image()).to(torch.bfloat16)
    rois = torch.from_numpy(_rois(n=4))
    before = _cuda.LAUNCHES[KERNEL]
    got = crop_rois(image, rois, (16, 16), 1)
    assert got.dtype == torch.bfloat16
    assert _cuda.LAUNCHES[KERNEL] == before
    ref = crop_rois(image.float(), rois, (16, 16), 1)
    assert torch.equal(got, ref.to(torch.bfloat16))


def test_normalize_requires_uint8():
    with pytest.raises(NotImplementedError):
        crop_rois(torch.zeros(8, 8, 3), torch.zeros(1, 5), (4, 4), 1, 2, normalize=(MEAN, STD))
