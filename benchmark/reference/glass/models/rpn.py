"""Rotated region proposal network at inference.

Counterpart of ``glass_tpu/models/rpn.py``: d2 ``RotatedAnchorGenerator``
cell anchors, ``StandardRPNHead``, and per-level top-k -> decode -> clip ->
exact rotated NMS -> global top-k proposal selection over fixed-capacity
padded sets, over a batch of images (``select_proposals_batch``) or one.

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
from ..ops.nms_rotated import NEG_INF, nms_rotated_mask_batched


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
    """``lax.top_k`` semantics over the last axis: descending, lower index
    first on ties."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


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


def select_proposals_batch(
    logits: List[torch.Tensor],
    deltas: List[torch.Tensor],
    anchors: List[torch.Tensor],
    image_sizes,
    bbox_reg_weights,
    pre_nms_topk: int,
    post_nms_topk: int,
    nms_thresh: float,
    min_size: float = 0.0,
):
    """Per image and level: top-k, decode, clip, exact NMS; then each
    image's global top-k.

    logits (B, H*W*A) and deltas (B, H*W*A, 5) per level, anchors (H*W*A,
    5) per level; image_sizes: a (B, 2) f32 tensor of each image's (h, w),
    or one (h, w) for every image.  The NMS of every (level, image) set is
    one batched call, each level's sets padded to the largest with invalid
    rows (which are never kept and suppress nothing).
    Returns boxes (B, post, 5), scores (B, post), valid (B, post), each row
    score-sorted.
    """
    sets = []
    for lg, dl, an in zip(logits, deltas, anchors):
        k = min(pre_nms_topk, lg.shape[1])
        scores, idx = top_k(lg, k)
        # decode in f32 whatever the head's compute dtype
        picked = torch.gather(dl, 1, idx[..., None].expand(-1, -1, dl.shape[2]))
        boxes = apply_deltas(picked.to(torch.float32), an[idx], bbox_reg_weights)
        boxes = clip_rotated_boxes(boxes, image_sizes)
        valid = (
            torch.isfinite(scores)
            & torch.all(torch.isfinite(boxes), dim=-1)
            & nonempty(boxes, min_size)
        )
        sets.append((boxes, scores, valid))
    width = max(s[1].shape[1] for s in sets)

    def padded(t, value):
        fill = t.new_full((t.shape[0], width - t.shape[1]) + tuple(t.shape[2:]), value)
        return torch.cat([t, fill], dim=1)

    keep = nms_rotated_mask_batched(
        torch.cat([padded(b, 0.0) for b, _, _ in sets]),
        torch.cat([padded(s, NEG_INF) for _, s, _ in sets]),
        nms_thresh,
        valid=torch.cat([padded(v, False) for _, _, v in sets]),
    ).view(len(sets), -1, width)
    keep = torch.cat([keep[i, :, : s[1].shape[1]] for i, s in enumerate(sets)], dim=1)
    boxes = torch.cat([s[0] for s in sets], dim=1)
    scores = torch.cat([s[1] for s in sets], dim=1)
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    top_scores, top_idx = top_k(scores, post_nms_topk)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 5))
    return top_boxes, top_scores, torch.gather(keep, 1, top_idx) & (top_scores > NEG_INF / 2)


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
    """``select_proposals_batch`` for one image: logits (H*W*A,), deltas
    (H*W*A, 5), anchors (H*W*A, 5) per level.  Returns boxes (post, 5),
    scores (post,), valid (post,), score-sorted."""
    out = select_proposals_batch(
        [lg[None] for lg in logits], [d[None] for d in deltas], anchors, image_size,
        bbox_reg_weights, pre_nms_topk, post_nms_topk, nms_thresh, min_size,
    )
    return tuple(t[0] for t in out)
