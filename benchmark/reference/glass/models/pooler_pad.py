"""Aspect-ratio-preserving pooler padding (FeatPadV2).

Counterpart of ``glass_tpu/models/pooler_pad.py`` (reference
``glass/modeling/recognition/recognizer_pooler_pad.py:28-95``): a word box
narrower than the pooler's target aspect is widened symmetrically before
the recognizer's pool, and the pooled columns that came from the padding
are zeroed afterwards.  On rotated XYWHA boxes the widening is a larger
``w``; the box frame does the rest.  The raw-image crops keep the original
boxes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def feat_pad_v2_boxes(boxes: torch.Tensor, output_size: Tuple[int, int]):
    """Widen narrow boxes to the pooler aspect.

    boxes (..., 5) XYWHA; output_size (pooled_h, pooled_w).
    Returns (widened boxes, ratio); ratio > 1 marks widened rows.
    """
    dst_aspect = output_size[1] / output_size[0]
    w, h = boxes[..., 2], boxes[..., 3]
    src_aspect = w / torch.clamp(h, min=1e-6)
    ratio = dst_aspect / torch.clamp(src_aspect, min=1e-6)
    out = boxes.clone()
    out[..., 2] = torch.where(ratio > 1, w * ratio, w)
    return out, ratio


def feat_pad_v2_mask(pooled: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """Zero the pooled columns contributed by padding.

    pooled (R, ph, pw, C); ratio (R,) from ``feat_pad_v2_boxes``.
    """
    pw = pooled.shape[2]
    pad_cols = torch.where(ratio > 1, (ratio - 1) / ratio * pw / 2.0, torch.zeros_like(ratio))
    col = torch.arange(pw, dtype=pooled.dtype, device=pooled.device)[None, :]
    keep = (col >= pad_cols[:, None]) & (col < (pw - pad_cols)[:, None])  # (R, pw)
    return pooled * keep[:, None, :, None].to(pooled.dtype)


def padded_pool(arch, boxes: torch.Tensor, pool_fn) -> torch.Tensor:
    """The recognizer's pool under ``arch.pooler_pad``: ``pool_fn`` maps
    (R, 5) boxes to (R, ph, pw, C).  Under FeatPadV2 it takes the widened
    boxes and the padding columns are zeroed; otherwise ``boxes`` as they are.
    """
    if arch.pooler_pad != "FeatPadV2":
        return pool_fn(boxes)
    widened, ratio = feat_pad_v2_boxes(boxes, arch.recognizer_pool_hw)
    return feat_pad_v2_mask(pool_fn(widened), ratio)
