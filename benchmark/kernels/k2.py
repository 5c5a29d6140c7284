"""K2, the rotated crops of the raw images (``csrc/crop_rois.cu`` behind
``ops/crop.py::crop_rois_batched``, which ``models/glass_rcnn.py`` calls by
its own imported name).

Bytes: the crops (B, R, OH, OW, 3) written, plus the distinct pixels of
three channels the bilinear taps touch, read once.  Operations: as K1's,
8 per channel per sample."""

import torch

from benchmark.harness.roofline import samples, touched_rows
from benchmark.reference.glass.ops.roi_align_rotated import adaptive_grid, fixed_grid

SEAMS = [("glass_tpu_torch.ops.crop", "crop_rois_batched"),
         ("glass_tpu_torch.models.glass_rcnn", "crop_rois_batched")]


def _args(images, rois, out_hw=(128, 128), sampling_ratio=1, max_sampling_ratio=2, normalize=None):
    return images, rois, out_hw, sampling_ratio, max_sampling_ratio


def record(args, kwargs, out):
    images, rois, out_hw, sampling_ratio, max_sampling_ratio = _args(*args, **kwargs)
    if not images.is_cuda:
        return None
    return {"images_shape": tuple(images.shape), "image_elt": images.element_size(),
            "rois": rois.detach().clone(), "out_hw": tuple(int(v) for v in out_hw),
            "sampling_ratio": int(sampling_ratio), "max_sampling_ratio": max_sampling_ratio,
            "out_elt": out.element_size()}


def is_kernel(name: str) -> bool:
    return "crop_rois_kernel" in name


def cost(call: dict):
    """(bytes, operations) of one K2 call over a batch."""
    rois, out_hw = call["rois"], call["out_hw"]
    b, h, w, _ = call["images_shape"]
    total_rows = 0
    ops = 0
    for i in range(b):
        r = rois[i].float()
        grid = (fixed_grid(r.shape[0], call["sampling_ratio"], r.device) if call["sampling_ratio"] > 0
                else adaptive_grid(r[:, 3], r[:, 2], out_hw, call["max_sampling_ratio"]))
        meta = torch.tensor([[1.0, float(h), float(w), 0.0]], device=r.device)
        levels = torch.zeros((r.shape[0],), dtype=torch.int32, device=r.device)
        total_rows += touched_rows(meta, r, levels, grid, out_hw)
        ops += 8 * 3 * samples(grid, out_hw)
    out = rois.shape[0] * rois.shape[1] * out_hw[0] * out_hw[1] * 3 * call["out_elt"]
    return out + total_rows * 3 * call["image_elt"], ops
