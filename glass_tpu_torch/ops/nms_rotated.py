"""Exact greedy rotated NMS returning a fixed-size keep mask.

Counterpart of ``glass_tpu/ops/nms_rotated.py`` (same algorithm): sort by
score (stable, so ties keep index order as ``jnp.argsort`` does), build the
pairwise IoU matrix, then iterate the all-at-once suppression operator to
its fixpoint, which is the exact greedy solution.
"""

from __future__ import annotations

import torch

from .iou_rotated import pairwise_iou_rotated

NEG_INF = -1e30


def nms_rotated_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
    max_keep: int | None = None,
) -> torch.Tensor:
    """(N, 5) boxes, (N,) scores -> (N,) bool keep mask in input order."""
    n = boxes.shape[0]
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(-scores, stable=True).indices
    sorted_boxes = boxes[order]
    sorted_valid = scores[order] > NEG_INF / 2

    iou = pairwise_iou_rotated(sorted_boxes, sorted_boxes)
    rank = torch.arange(n, device=boxes.device)
    sup = (
        (iou > iou_threshold)
        & (rank[:, None] < rank[None, :])
        & sorted_valid[:, None]
        & sorted_valid[None, :]
    ).to(torch.float32)

    # keep(i) <=> valid(i) and no higher-ranked KEPT box overlaps it;
    # converges in (suppression chain depth) steps.
    keep = sorted_valid
    for _ in range(n):
        new_keep = sorted_valid & ~((keep.to(torch.float32) @ sup) > 0.5)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep

    if max_keep is not None:
        kept_rank = torch.cumsum(keep.to(torch.int32), 0) - 1
        keep = keep & (kept_rank < max_keep)

    out = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    out[order] = keep
    return out
