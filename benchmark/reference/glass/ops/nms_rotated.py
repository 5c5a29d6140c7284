"""Exact greedy rotated NMS returning a fixed-size keep mask.

Counterpart of ``glass_tpu/ops/nms_rotated.py`` (same algorithm): sort by
score (stable, so ties keep index order as ``jnp.argsort`` does), build the
pairwise IoU matrix, then iterate the all-at-once suppression operator to
its fixpoint, which is the exact greedy solution.

``nms_rotated_mask_batched`` runs B independent sets in one program, with
one convergence test (a host sync) an iteration for the whole batch: a
converged row is a fixpoint of the operator, so the rows still moving take
it on without changing it.  ``nms_rotated_mask`` is its one-row case.
"""

from __future__ import annotations

import torch

from .iou_rotated import pairwise_iou_rotated

NEG_INF = -1e30


def nms_rotated_mask_batched(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
    max_keep: int | None = None,
) -> torch.Tensor:
    """(B, N, 5) boxes, (B, N) scores -> (B, N) bool keep mask in input
    order; ``valid`` (B, N); ``max_keep`` caps the kept boxes of each row."""
    n = boxes.shape[1]
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(-scores, dim=1, stable=True).indices
    sorted_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, boxes.shape[2]))
    sorted_valid = torch.gather(scores, 1, order) > NEG_INF / 2

    iou = pairwise_iou_rotated(sorted_boxes, sorted_boxes)
    rank = torch.arange(n, device=boxes.device)
    sup = (
        (iou > iou_threshold)
        & (rank[:, None] < rank[None, :])
        & sorted_valid[:, :, None]
        & sorted_valid[:, None, :]
    ).to(torch.float32)

    # keep(i) <=> valid(i) and no higher-ranked KEPT box overlaps it;
    # converges in (suppression chain depth) steps.
    keep = sorted_valid
    for _ in range(n):
        suppressed = torch.bmm(keep.to(torch.float32)[:, None, :], sup)[:, 0] > 0.5
        new_keep = sorted_valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep

    if max_keep is not None:
        kept_rank = torch.cumsum(keep.to(torch.int32), 1) - 1
        keep = keep & (kept_rank < max_keep)

    return torch.zeros_like(keep).scatter_(1, order, keep)


def nms_rotated_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
    max_keep: int | None = None,
) -> torch.Tensor:
    """(N, 5) boxes, (N,) scores -> (N,) bool keep mask in input order."""
    return nms_rotated_mask_batched(boxes[None], scores[None], iou_threshold,
                                    None if valid is None else valid[None], max_keep)[0]
