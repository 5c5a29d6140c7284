"""Shared small utilities (reference glass/utils/common_utils.py)."""

from __future__ import annotations

import numpy as np


def rgb2grey(image: np.ndarray, three_channels: bool = False) -> np.ndarray:
    """Rec.709 luma grayscale, optionally replicated to 3 channels."""
    grey = (
        0.2126 * image[..., 0] + 0.7152 * image[..., 1] + 0.0722 * image[..., 2]
    ).astype(image.dtype)
    if three_channels:
        return np.stack([grey, grey, grey], axis=-1)
    return grey[..., None]


# Reference tools/eval_glass.py:147-181 buckets parameters by module-name
# substring with an elif chain — first match in this order wins.
_CENSUS_BUCKETS = (
    "backbone",
    "hybrid_net",
    "fusion_net",
    "mask_head",
    "box_head",
    "recognizer_head",
    "rpn_head",
)


def parameter_census(model) -> dict:
    """Per-module trainable-parameter counts of a ``torch.nn.Module``
    (reference eval-CLI census, ``tools/eval_glass.py:147-181``).

    Returns ``{"per_param": {name: count}, "buckets": {bucket: count},
    "total": N}`` where names are the model's ``named_parameters()`` names
    (detectron2's) and buckets use the reference's substring/elif-order rule.
    """
    per_param = {}
    buckets = {b: 0 for b in _CENSUS_BUCKETS}
    total = 0
    for name, p in sorted(model.named_parameters()):
        n = int(p.numel())
        per_param[name] = n
        total += n
        for b in _CENSUS_BUCKETS:
            if b in name:
                buckets[b] += n
                break
    return {"per_param": per_param, "buckets": buckets, "total": total}


def format_parameter_census(census: dict, per_param: bool = False) -> str:
    """Human-readable census table (reference prints per-name lines plus a
    per-bucket millions summary)."""
    lines = []
    if per_param:
        for name, n in census["per_param"].items():
            lines.append(f"{name} Total Trainable Params: {n}")
    lines.append(f"Total Trainable Params: {census['total']}")
    lines.append(
        "Per-module (M): "
        + " ".join(
            f"{b} {census['buckets'][b] / 1e6:.3f}" for b in _CENSUS_BUCKETS
        )
    )
    return "\n".join(lines)
