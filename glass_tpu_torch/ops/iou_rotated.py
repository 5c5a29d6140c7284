"""Pairwise rotated-box IoU / IoA in plain PyTorch.

Counterpart of ``glass_tpu/ops/iou_rotated.py`` (same algorithm): the
intersection area is ``∮ x dy`` over the intersection boundary (Green's
theorem), which splits into the parts of P's edges inside Q plus the parts
of Q's edges inside P; each part is a parameter interval from a slab test
against the other rectangle's four half-planes, with a closed-form
integral.  No polygon collection, no sort.  Rows are processed in chunks
to bound peak memory.
"""

from __future__ import annotations

import torch

from .boxes import boxes_to_polygons

_CHUNK = 256


def _edges_inside_integral(p, pn, q, qn, eps=0.0, scale=1.0):
    """Sum of ``∮ x dy`` over the parts of P's edges inside Q.

    p, pn: (x, y) of P's edge starts/ends, (4, M, 1); q, qn: Q's, (4, 1, N).
    ``eps`` is a band relative to the per-pair ``scale`` (M, N) that makes
    the inside test strict (eps > 0) or inclusive (eps < 0), so boundary
    segments shared by both rectangles are counted exactly once.
    """
    px, py = p
    pnx, pny = pn
    qx, qy = q
    qnx, qny = qn
    dx = pnx - px
    dy = pny - py
    qdx = (qnx - qx)[None]  # (1, 4q, 1, N)
    qdy = (qny - qy)[None]
    qlen = torch.sqrt(qdx * qdx + qdy * qdy)
    c0 = (
        qdx * (py[:, None] - qy[None])
        - qdy * (px[:, None] - qx[None])
        - (eps * qlen) * scale
    )
    c1 = qdx * dy[:, None] - qdy * dx[:, None]  # (4p, 4q, M, N)

    big = 1e30
    degenerate = torch.abs(c1) < 1e-12
    safe_c1 = torch.where(degenerate, torch.full_like(c1, 1e-12), c1)
    t_cross = -c0 / safe_c1
    pos_big = torch.full_like(c1, big)
    neg_big = torch.full_like(c1, -big)
    lo_j = torch.where(degenerate, torch.where(c0 >= 0, neg_big, pos_big),
                       torch.where(c1 > 0, t_cross, neg_big))
    hi_j = torch.where(degenerate, torch.where(c0 >= 0, pos_big, neg_big),
                       torch.where(c1 < 0, t_cross, pos_big))
    t_lo = torch.clamp(torch.amax(lo_j, dim=1), 0.0, 1.0)  # (4p, M, N)
    t_hi = torch.clamp(torch.amin(hi_j, dim=1), 0.0, 1.0)
    t_hi = torch.maximum(t_hi, t_lo)
    seg = dy * (px * (t_hi - t_lo) + dx * (t_hi ** 2 - t_lo ** 2) * 0.5)
    return seg.sum(dim=0)  # (M, N)


def _intersection_chunk(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Intersection areas for polygon chunks: (M,4,2) x (N,4,2) -> (M,N)."""
    p1x = p1[:, :, 0].T[:, :, None]  # (4, M, 1)
    p1y = p1[:, :, 1].T[:, :, None]
    p2x = p2[:, :, 0].T[:, None, :]  # (4, 1, N)
    p2y = p2[:, :, 1].T[:, None, :]
    # Recenter every pair at the midpoint of the two box centres: the slab
    # cross products cancel catastrophically in f32 at image coordinates.
    cx = (p1x.mean(dim=0) + p2x.mean(dim=0)) * 0.5  # (M, N)
    cy = (p1y.mean(dim=0) + p2y.mean(dim=0)) * 0.5
    p1x, p1y = p1x - cx, p1y - cy
    p2x, p2y = p2x - cx, p2y - cy
    p1nx = torch.roll(p1x, -1, dims=0)
    p1ny = torch.roll(p1y, -1, dims=0)
    p2nx = torch.roll(p2x, -1, dims=0)
    p2ny = torch.roll(p2y, -1, dims=0)
    r2_1 = torch.amax(p1x * p1x + p1y * p1y, dim=0)
    r2_2 = torch.amax(p2x * p2x + p2y * p2y, dim=0)
    scale = torch.sqrt(torch.clamp(torch.maximum(r2_1, r2_2), min=1e-12))
    total = _edges_inside_integral(
        (p1x, p1y), (p1nx, p1ny), (p2x, p2y), (p2nx, p2ny), eps=-3e-5, scale=scale,
    ) + _edges_inside_integral(
        (p2x, p2y), (p2nx, p2ny), (p1x, p1y), (p1nx, p1ny), eps=3e-5, scale=scale,
    )
    return torch.abs(total)


def pairwise_intersection_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(M,5) x (N,5) XYWHA -> (M,N) intersection areas."""
    p1 = boxes_to_polygons(boxes1.to(torch.float32))
    p2 = boxes_to_polygons(boxes2.to(torch.float32))
    if p1.shape[0] <= _CHUNK:
        return _intersection_chunk(p1, p2)
    return torch.cat([_intersection_chunk(c, p2) for c in p1.split(_CHUNK)], dim=0)


def pairwise_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(M,5) x (N,5) XYWHA -> (M,N) IoU, detectron2-compatible semantics."""
    inter = pairwise_intersection_rotated(boxes1, boxes2)
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    union = a1 + a2 - inter
    zero = torch.zeros_like(inter)
    iou = torch.where(union > 1e-12, inter / union, zero)
    valid = (a1 > 1e-14) & (a2 > 1e-14)
    return torch.clamp(torch.where(valid, iou, zero), 0.0, 1.0)


def pairwise_ioa_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection over the smaller of the two areas (reference
    ``glass/structures/boxes.py:23-48``: inter = iou (a1 + a2) / (1 + iou))."""
    iou = pairwise_iou_rotated(boxes1, boxes2)
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    inter = (a1 + a2) * iou / (1.0 + iou)
    min_area = torch.minimum(a1, a2)
    return torch.where(min_area > 1e-12, inter / min_area, torch.zeros_like(inter))
