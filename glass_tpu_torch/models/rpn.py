"""Rotated region proposal network at inference.

Counterpart of ``glass_tpu/models/rpn.py``: d2 ``RotatedAnchorGenerator``
cell anchors, ``StandardRPNHead``, and per-level top-k -> decode -> clip ->
exact rotated NMS -> global top-k proposal selection over fixed-capacity
padded sets.

Tie order: ``lax.top_k`` (and glass_tpu's ``exact_top_k``) put lower
indices first among equal values, while ``torch.topk`` promises no tie
order; every top-k here is a stable descending sort.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import layers as L
from ..ops.boxes import apply_deltas, clip_rotated_boxes, nonempty
from ..ops.nms_rotated import NEG_INF, nms_rotated_mask


def generate_cell_anchors(sizes, aspect_ratios, angles) -> np.ndarray:
    """detectron2 ``RotatedAnchorGenerator.generate_cell_anchors``."""
    anchors = []
    for size in sizes:
        area = size**2
        for aspect in aspect_ratios:
            w = math.sqrt(area / aspect)
            h = aspect * w
            for angle in angles:
                anchors.append([0.0, 0.0, w, h, angle])
    return np.array(anchors, np.float32)


def generate_anchors_for_level(
    grid_h: int, grid_w: int, stride: int, cell_anchors: np.ndarray, offset: float = 0.0
) -> np.ndarray:
    """(H*W*A, 5) anchors, location-major/anchor-minor (d2 ordering)."""
    shifts_x = (np.arange(grid_w, dtype=np.float32) + offset) * stride
    shifts_y = (np.arange(grid_h, dtype=np.float32) + offset) * stride
    sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
    zeros = np.zeros(sx.size, np.float32)
    shifts = np.stack([sx.ravel(), sy.ravel(), zeros, zeros, zeros], axis=1)
    anchors = shifts[:, None, :] + cell_anchors[None, :, :]
    return anchors.reshape(-1, 5)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics: descending, lower index first on ties."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


class StandardRPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / 1x1 deltas (d2 names)."""

    def __init__(self, channels: int, num_anchors: int, box_dim: int = 5):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * box_dim, 1)

    def forward(self, features: Sequence[torch.Tensor]):
        """features: list of (N, C, H, W).  Returns objectness (N, H*W*A)
        and deltas (N, H*W*A, 5) per level, in the anchor ordering of
        ``generate_anchors_for_level``."""
        logits, deltas = [], []
        for f in features:
            t = L.relu(L.conv2d(f, self.conv.weight, self.conv.bias, padding=1))
            obj = L.conv2d(t, self.objectness_logits.weight, self.objectness_logits.bias)
            dlt = L.conv2d(t, self.anchor_deltas.weight, self.anchor_deltas.bias)
            n = obj.shape[0]
            logits.append(obj.permute(0, 2, 3, 1).reshape(n, -1))
            deltas.append(dlt.permute(0, 2, 3, 1).reshape(n, -1, 5))
        return logits, deltas


def select_proposals_single_image(
    logits: List[torch.Tensor],
    deltas: List[torch.Tensor],
    anchors: List[torch.Tensor],
    image_size: Tuple[float, float],
    bbox_reg_weights,
    pre_nms_topk: int,
    post_nms_topk: int,
    nms_thresh: float,
    min_size: float = 0.0,
):
    """Per level: top-k, decode, clip, exact NMS; then the global top-k.

    logits (H*W*A,), deltas (H*W*A, 5), anchors (H*W*A, 5) per level.
    Returns boxes (post, 5), scores (post,), valid (post,), score-sorted.
    """
    all_boxes, all_scores, all_valid = [], [], []
    for lg, dl, an in zip(logits, deltas, anchors):
        k = min(pre_nms_topk, lg.shape[0])
        scores, idx = top_k(lg, k)
        # decode in f32 whatever the head's compute dtype
        boxes = apply_deltas(dl[idx].to(torch.float32), an[idx], bbox_reg_weights)
        boxes = clip_rotated_boxes(boxes, image_size)
        valid = (
            torch.isfinite(scores)
            & torch.all(torch.isfinite(boxes), dim=-1)
            & nonempty(boxes, min_size)
        )
        keep = nms_rotated_mask(boxes, scores, nms_thresh, valid=valid)
        all_boxes.append(boxes)
        all_scores.append(torch.where(keep, scores, torch.full_like(scores, NEG_INF)))
        all_valid.append(keep)
    boxes = torch.cat(all_boxes, dim=0)
    scores = torch.cat(all_scores, dim=0)
    valid = torch.cat(all_valid, dim=0)
    top_scores, top_idx = top_k(scores, post_nms_topk)
    return boxes[top_idx], top_scores, valid[top_idx] & (top_scores > NEG_INF / 2)
