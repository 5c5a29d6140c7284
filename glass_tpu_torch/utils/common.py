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
