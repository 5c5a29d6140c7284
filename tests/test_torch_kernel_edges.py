"""The edge cases of kernels K1 and K2 (glass_tpu_torch/csrc) that their
work split treats apart, and that chip_smoke.py phases 2-3 hold on the card
against the plain versions: here the plain versions against glass_tpu on
the CPU.  K1: no roi, one roi, every roi on the full 4x4 grid, a 6x6 grid
(more samples a bin than a warp's 32-entry table), C of one 16-byte
vector.  K2: no roi, one roi, a ragged output (fewer columns than a block
has threads, rows no multiple of a block's band), a one-pixel-wide image.
Also the shapes the kernels refuse, which the wrappers raise on before any
launch.

glass_tpu's pooler takes no one-pixel-wide map, so that case is held
against the numpy transcription of detectron2's ROIAlignRotated spec
(tests/test_golden_kernel_vectors.py) on the normalized image.
Tolerances as tests/test_torch_roi_align.py and tests/test_torch_crop.py
state them: 1e-4 abs, and 1e-4 * 255 / min(std) for the uint8 fold.
"""

import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_golden_kernel_vectors import _spec_roi_align_rotated  # noqa: E402

from glass_tpu_torch.ops import crop as cr  # noqa: E402
from glass_tpu_torch.ops import roi_align_rotated as ra  # noqa: E402

J = importlib.import_module("glass_tpu.ops.roi_align_rotated")

torch.set_num_threads(2)
TOL = 1e-4
MEAN = np.array([103.53, 116.28, 123.675], np.float32)
STD = np.array([57.375, 57.12, 58.395], np.float32)


def _rois(rng, n, h, w):
    return np.stack([rng.uniform(-10, w + 10, n), rng.uniform(-10, h + 10, n),
                     rng.uniform(4, 160, n), rng.uniform(3, 60, n),
                     rng.uniform(-180, 180, n)], 1).astype(np.float32)


# (id, rois, channels, output, sampling ratio); sampling ratio 0 is the
# adaptive grid capped at 4
K1_CASES = [
    ("no roi", 0, 16, (14, 14), 0),
    ("one roi", 1, 16, (14, 14), 0),
    ("full 4x4 grid", 12, 16, (14, 14), 4),
    ("6x6 grid", 6, 8, (7, 7), 6),
    ("C of one f32 vector", 12, 4, (8, 32), 2),
]


@pytest.mark.parametrize("n,channels,output_size,sampling_ratio", [c[1:] for c in K1_CASES],
                         ids=[c[0] for c in K1_CASES])
def test_k1_edge_cases_match_glass_tpu(n, channels, output_size, sampling_ratio):
    rng = np.random.RandomState(20 + n)
    feat = rng.randn(40, 56, channels).astype(np.float32)
    rois = _rois(rng, n, 160, 224)
    want = np.asarray(J.roi_align_rotated(jnp.asarray(feat), jnp.asarray(rois), output_size,
                                          spatial_scale=0.25, sampling_ratio=sampling_ratio,
                                          max_sampling_ratio=4))
    got = ra.roi_align_rotated(torch.from_numpy(feat), torch.from_numpy(rois), output_size, 0.25,
                               sampling_ratio, 4).numpy()
    assert got.shape == (n, *output_size, channels)
    np.testing.assert_allclose(got, want, atol=TOL)


# (id, rois, image width, output, sampling ratio, uint8 with the fold)
K2_CASES = [
    ("no roi", 0, 220, (128, 128), 0, False),
    ("one roi", 1, 220, (128, 128), 0, False),
    ("ragged 32x100", 12, 220, (32, 100), 2, False),
    ("ragged 32x100 uint8 fold", 12, 220, (32, 100), 2, True),
    ("one-pixel-wide image", 6, 1, (16, 8), 2, False),
    ("one-pixel-wide image uint8 fold", 6, 1, (16, 8), 2, True),
]


@pytest.mark.parametrize("n,width,out_hw,sampling_ratio,fold", [c[1:] for c in K2_CASES],
                         ids=[c[0] for c in K2_CASES])
def test_k2_edge_cases_match_glass_tpu(n, width, out_hw, sampling_ratio, fold):
    rng = np.random.RandomState(40 + n)
    image = rng.rand(180, width, 3).astype(np.float32)
    rois = _rois(rng, n, 180, width)
    normalize, tol = None, TOL
    if fold:
        image, normalize, tol = (image * 255).astype(np.uint8), (MEAN, STD), TOL * 255 / STD.min()
    if width == 1:
        norm = image if normalize is None else (image.astype(np.float32) - MEAN) / STD
        want = _spec_roi_align_rotated(norm, rois, out_hw, 1.0, sampling_ratio)
    else:
        want = np.asarray(J.roi_align_rotated(
            jnp.asarray(image), jnp.asarray(rois), out_hw, spatial_scale=1.0,
            sampling_ratio=sampling_ratio, max_sampling_ratio=2,
            normalize=None if normalize is None else tuple(jnp.asarray(v) for v in normalize)))
    got = cr.crop_rois(torch.from_numpy(image), torch.from_numpy(rois), out_hw, sampling_ratio, 2,
                       normalize).numpy()
    assert got.shape == (n, *out_hw, 3)
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("dtype,channels,width", [(torch.float32, 6, 4), (torch.bfloat16, 12, 8),
                                                  (torch.float16, 12, 8)])
def test_k1_wrapper_raises_on_channels_the_kernel_does_not_take(dtype, channels, width):
    """C must be a multiple of the kernel's 16-byte vector; the check runs
    before any launch, so it shows on a meta tensor."""
    assert ra.vector_width(dtype) == width
    flat = torch.zeros((64, channels), dtype=dtype, device="meta")
    meta = torch.tensor([[1.0, 8.0, 8.0, 0.0]], device="meta")
    with pytest.raises(ValueError, match=f"multiple of {width}"):
        ra.roi_align_rotated_packed(
            flat, meta, torch.zeros((1, 5), device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.full((1, 2), 2, dtype=torch.int32, device="meta"), (2, 2))


def test_k2_wrapper_raises_on_a_one_pixel_image():
    with pytest.raises(ValueError, match="two pixels"):
        cr.crop_rois(torch.zeros((1, 1, 3), device="meta"), torch.zeros((1, 5), device="meta"), (4, 4), 1)
