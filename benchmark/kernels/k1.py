"""K1, the rotated RoIAlign forward (``csrc/roi_align_rotated.cu`` behind
``ops/roi_align_rotated.py::_pool_forward``).

Bytes: the pooled output (R, ph, pw, C) written, plus the distinct feature
rows of C channels that the bilinear taps of in-bounds samples touch, read
once.  Operations: 8 per channel per sample (four taps, a multiply and an
add each)."""

from benchmark.harness.roofline import samples, touched_rows

SEAMS = [("glass_tpu_torch.ops.roi_align_rotated", "_pool_forward")]


def _args(flat, meta, rois, levels, grid, output_size):
    return flat, meta, rois, levels, grid, output_size


def record(args, kwargs, out):
    flat, meta, rois, levels, grid, output_size = _args(*args, **kwargs)
    if not flat.is_cuda:
        return None
    return {"meta": meta.detach().clone(), "rois": rois.detach().float().clone(), "levels": levels.clone(),
            "grid": grid.clone(), "out_hw": tuple(int(v) for v in output_size), "channels": flat.shape[1],
            "elt": flat.element_size()}


def is_kernel(name: str) -> bool:
    return "roi_align_rotated_kernel" in name


def cost(call: dict):
    """(bytes, operations) of one K1 call."""
    c, elt = call["channels"], call["elt"]
    out = call["rois"].shape[0] * call["out_hw"][0] * call["out_hw"][1] * c * elt
    rows = touched_rows(call["meta"], call["rois"], call["levels"], call["grid"], call["out_hw"])
    return out + rows * c * elt, 8 * c * samples(call["grid"], call["out_hw"])
