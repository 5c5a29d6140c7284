"""Mask targets built on the device.

Counterpart of ``glass_tpu/train/targets.py``: the 28 x 28 target grid of
every sampled proposal is mapped into image coordinates through the
proposal's rotated frame (the RoIAlign sampling formula) and tested against
its gt polygon with a crossing-number test, over polygons padded to a fixed
vertex count.  No host round trip.
"""

from __future__ import annotations

import math

import torch


def points_in_polygon(points: torch.Tensor, polygon: torch.Tensor, n_vertices: torch.Tensor):
    """Crossing-number test, batched over polygons.

    points (P, ..., 2); polygon (P, K, 2) padded vertices; n_vertices (P,)
    valid vertex counts.  Returns (P, ...) bool.
    """
    k = polygon.shape[1]
    idx = torch.arange(k, device=polygon.device)
    nv = n_vertices[:, None]
    nxt = torch.where(idx[None, :] + 1 >= nv, torch.zeros_like(idx)[None, :], idx[None, :] + 1)
    v1 = torch.gather(polygon, 1, nxt[..., None].expand(-1, -1, 2))
    valid_edge = idx[None, :] < nv  # (P, K)
    extra = points.dim() - 2
    view = (polygon.shape[0],) + (1,) * extra + (k,)
    x0, y0 = polygon[..., 0].reshape(view), polygon[..., 1].reshape(view)
    x1, y1 = v1[..., 0].reshape(view), v1[..., 1].reshape(view)
    px = points[..., 0][..., None]
    py = points[..., 1][..., None]
    straddle = (y0 > py) != (y1 > py)
    denom = y1 - y0
    t = (py - y0) / torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    x_int = x0 + t * (x1 - x0)
    crossing = straddle & (px < x_int) & valid_edge.reshape(view)
    return crossing.to(torch.int32).sum(dim=-1) % 2 == 1


def rasterize_polygons_in_rotated_boxes(polygons, n_vertices, boxes, mask_size: int = 28):
    """(P, K, 2) polygons in image coordinates, (P,) vertex counts, (P, 5)
    boxes -> (P, S, S) bool: the grid centres of each box frame (rotation by
    the box angle about its centre, the ROIAlignRotated convention) inside
    its polygon."""
    cx, cy, w, h, a = boxes.unbind(-1)
    theta = a * math.pi / 180.0
    cos_t, sin_t = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    s = (torch.arange(mask_size, dtype=torch.float32, device=boxes.device) + 0.5) / mask_size
    yy = (s - 0.5)[None, :] * h[:, None]
    xx = (s - 0.5)[None, :] * w[:, None]
    y = yy[:, :, None] * cos_t - xx[:, None, :] * sin_t + cy[:, None, None]
    x = yy[:, :, None] * sin_t + xx[:, None, :] * cos_t + cx[:, None, None]
    return points_in_polygon(torch.stack([x, y], dim=-1), polygons, n_vertices)


def mask_targets_for_proposals(polygons, n_vertices, matched_gt_idx, proposal_boxes,
                               mask_size: int = 28):
    """(G, K, 2) polygons + (P,) matching + (P, 5) boxes -> (P, S, S)."""
    idx = matched_gt_idx.long()
    return rasterize_polygons_in_rotated_boxes(
        polygons[idx], n_vertices[idx], proposal_boxes, mask_size
    )
