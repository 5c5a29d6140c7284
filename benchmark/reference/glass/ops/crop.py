"""Rotated crops of the raw image in plain PyTorch: ``ROIAlignRotated`` at
``spatial_scale=1`` over an ``(H, W, 3)`` image, writing ``(R, OH, OW, 3)``
crops (a frozen copy of the plain arithmetic of the port's crop).

* uint8 input, optionally with ``normalize=(mean, std)``: the crop of the
  normalized image, computed from the raw pixels; output f32.
* f32 input (already normalized): f32 output.
* ``sampling_ratio`` 1 or 2 is a fixed grid; 0 is adaptive
  ``ceil(extent / out)`` per axis, capped at ``max_sampling_ratio``.
"""

from __future__ import annotations

import torch

from .roi_align_rotated import adaptive_grid, fixed_grid, sample_grid_plain


def _output_dtype(image: torch.Tensor) -> torch.dtype:
    return torch.float32 if image.dtype == torch.uint8 else image.dtype


def _grid(rois, out_hw, sampling_ratio, max_sampling_ratio):
    if sampling_ratio > 0:
        return fixed_grid(rois.shape[0], sampling_ratio, rois.device)
    return adaptive_grid(rois[:, 3], rois[:, 2], out_hw, max_sampling_ratio)


def crop_rois_plain(image, rois, out_hw=(128, 128), sampling_ratio=1,
                    max_sampling_ratio=2, normalize=None):
    """Plain PyTorch version of K2."""
    h, w, _ = image.shape
    rois = rois.to(torch.float32)
    meta = torch.tensor([[1.0, float(h), float(w), 0.0]], device=image.device)
    levels = torch.zeros((rois.shape[0],), dtype=torch.int32, device=image.device)
    grid = _grid(rois, out_hw, sampling_ratio, max_sampling_ratio)
    if normalize is not None:
        normalize = tuple(torch.as_tensor(t, dtype=torch.float32, device=image.device)
                          for t in normalize)
    out = sample_grid_plain(image.reshape(h * w, 3), meta, rois, levels, grid, out_hw,
                            normalize=normalize)
    return out.to(_output_dtype(image))


def crop_rois_batched_plain(images, rois, out_hw=(128, 128), sampling_ratio=1,
                            max_sampling_ratio=2, normalize=None):
    """Plain PyTorch version of K2 over a batch: ``crop_rois_plain`` on each
    image."""
    oh, ow = (int(v) for v in out_hw)
    if images.shape[0] == 0:
        return torch.empty((0, rois.shape[1], oh, ow, 3), dtype=_output_dtype(images), device=images.device)
    return torch.stack([crop_rois_plain(im, r, out_hw, sampling_ratio, max_sampling_ratio, normalize)
                        for im, r in zip(images, rois)])


crop_rois_batched = crop_rois_batched_plain
crop_rois = crop_rois_plain
