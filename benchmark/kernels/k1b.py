"""K1b, the rotated RoIAlign backward (``csrc/roi_align_rotated_backward.cu``
behind ``ops/roi_align_rotated.py::roi_align_rotated_packed_backward``).

Bytes: the upstream gradient read, plus the dense gradient of the packed
features (n_rows, C) written once, as the call returns it.  Operations: as
K1's, 8 per channel per sample."""

import torch

from benchmark.harness.roofline import samples

SEAMS = [("glass_tpu_torch.ops.roi_align_rotated", "roi_align_rotated_packed_backward")]


def _args(grad_out, meta, rois, levels, grid, n_rows, out_dtype=torch.float32, **kw):
    return grad_out, rois, grid, n_rows, out_dtype


def record(args, kwargs, out):
    grad_out, rois, grid, n_rows, out_dtype = _args(*args, **kwargs)
    if not grad_out.is_cuda:
        return None
    return {"rois": rois.detach().clone(), "grid": grid.clone(), "out_hw": tuple(grad_out.shape[1:3]),
            "channels": grad_out.shape[-1], "elt": grad_out.element_size(), "n_rows": int(n_rows),
            "out_elt": torch.empty((), dtype=out_dtype).element_size()}


def is_kernel(name: str) -> bool:
    return "k1b::" in name


def cost(call: dict):
    """(bytes, operations) of one K1b call."""
    c = call["channels"]
    grad_in = call["rois"].shape[0] * call["out_hw"][0] * call["out_hw"][1] * c * call["elt"]
    return grad_in + call["n_rows"] * c * call["out_elt"], 8 * c * samples(call["grid"], call["out_hw"])
