"""Rotated crops of the raw image: kernel K2 and its plain PyTorch version.

Counterpart of ``glass_tpu/ops/pallas_crop.py`` (``crop_rois_pallas``) and of
the uint8 gather with the normalization folded in
(``roi_align_rotated(uint8_image, ..., normalize=(mean, std))``):
``ROIAlignRotated`` at ``spatial_scale=1`` over an ``(H, W, 3)`` image,
writing ``(R, OH, OW, 3)`` crops.

* uint8 input, optionally with ``normalize=(mean, std)``: the crop of the
  normalized image, computed from the raw pixels; output f32.
* f32 or bf16 input (already normalized): output in the input dtype, f32
  accumulation.
* ``sampling_ratio`` 1 or 2 is a fixed grid; 0 is adaptive
  ``ceil(extent / out)`` per axis, capped at ``max_sampling_ratio``.

On a CUDA tensor the wrapper launches ``csrc/crop_rois.cu`` or raises; on a
CPU tensor it runs the plain version.  The kernel takes an image of at
least two pixels whose start is aligned to two elements.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .roi_align_rotated import adaptive_grid, fixed_grid, sample_grid_plain

KERNEL = "crop_rois"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def _output_dtype(image: torch.Tensor) -> torch.dtype:
    return torch.float32 if image.dtype == torch.uint8 else image.dtype


def _check(image, rois, normalize):
    if image.dim() != 3 or image.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3), got {tuple(image.shape)}")
    if rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"rois must be (R, 5), got {tuple(rois.shape)}")
    if image.dtype not in _DTYPES:
        raise TypeError(f"image must be uint8, float32 or bfloat16, got {image.dtype}")
    if normalize is not None and image.dtype != torch.uint8:
        raise NotImplementedError("the normalize fold requires a uint8 image")
    if image.device != rois.device:
        raise ValueError("image and rois must lie on one device")


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


def crop_rois(image, rois, out_hw=(128, 128), sampling_ratio=1,
              max_sampling_ratio=2, normalize=None):
    """(H, W, 3) image, (R, 5) rois -> (R, OH, OW, 3) crops."""
    _check(image, rois, normalize)
    if image.device.type == "cpu":
        return crop_rois_plain(image, rois, out_hw, sampling_ratio, max_sampling_ratio, normalize)
    oh, ow = (int(v) for v in out_hw)
    h, w, _ = image.shape
    if h * w < 2:
        raise ValueError("the kernel needs an image of at least two pixels")
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    image = image.contiguous()
    if image.data_ptr() % (2 * image.element_size()):
        raise ValueError("the kernel needs an image aligned to two elements")
    rois = rois.to(torch.float32).contiguous()
    dev = image.device
    mean_ptr = std_ptr = None  # the kernel reads mean/std only under the fold
    if normalize is not None:
        mean, std = (torch.as_tensor(t, dtype=torch.float32, device=dev).contiguous()
                     for t in normalize)
        mean_ptr, std_ptr = mean.data_ptr(), std.data_ptr()
    r = rois.shape[0]
    out = torch.empty((r, oh, ow, 3), dtype=_output_dtype(image), device=dev)
    if out.numel() == 0:
        return out
    lib = _load()
    status = lib.glass_crop_rois(
        image.data_ptr(), _DTYPES[image.dtype], h, w, rois.data_ptr(), r,
        int(sampling_ratio), int(max_sampling_ratio), oh, ow, int(normalize is not None),
        mean_ptr, std_ptr, out.data_ptr(), _cuda.current_stream(dev),
    )
    _cuda.check_status(KERNEL, status)
    _cuda.LAUNCHES[KERNEL] += 1
    return out


def _load():
    lib = _cuda.load(KERNEL)
    fn = lib.glass_crop_rois
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, i, i, i, i, i, i, p, p, p, p]
        fn.restype = i
    return lib
