"""Minimum-area enclosing rotated rectangle of small point sets, batched.

Counterpart of ``glass_tpu/ops/min_area_rect.py``, which builds each
convex hull with a sequential monotone chain (nested ``while_loop``s) and
then projects the hull onto every hull-edge direction.  Here there is no
sequential hull: every ordered pair of distinct points (i, j) is a
candidate direction, kept when no point lies right of p_i -> p_j (so the
kept pairs are the hull's edges), and all P points of a set are projected
onto all P*P directions at once, for every set of the batch in one pass of
dense tensor ops.  The smallest area is glass_tpu's rectangle.

Ties: several directions give one rectangle (an edge taken either way, or
the perpendicular edge of an axis-aligned box).  They differ in the angle
by a multiple of 90 degrees, with w and h swapped for odd multiples; the
orientation rule of ``polygons_to_rotated_boxes`` maps all of them to the
same box, so the choice among them does not reach its output.
"""

from __future__ import annotations

import math

import torch

from .boxes import normalize_angle


def min_area_rect(points: torch.Tensor, valid: torch.Tensor | None = None):
    """Minimal-area enclosing rotated rectangle of each point set.

    Args:
        points: (..., P, 2) float points.
        valid: optional (..., P) bool mask of real points.

    Returns:
        (cx, cy, w, h, angle_deg), each (...): ``angle`` is the CCW rotation
        (image coordinates) of the edge taken as "width".  A set without two
        distinct valid points gives (0, 0, 0, 0, 0), as glass_tpu's does.
    """
    if valid is None:
        valid = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    px, py = points[..., 0], points[..., 1]                       # (..., P)
    # direction of the pair (i, j): p_j - p_i, (..., P_i, P_j)
    ex = px[..., None, :] - px[..., :, None]
    ey = py[..., None, :] - py[..., :, None]
    length = torch.sqrt(ex * ex + ey * ey)
    pair_ok = valid[..., :, None] & valid[..., None, :] & (length > 1e-9)
    ux = ex / torch.clamp(length, min=1e-9)
    uy = ey / torch.clamp(length, min=1e-9)

    # Keep the hull's edges: (i, j) with no valid point right of p_i -> p_j
    # (beyond a rounding band; the test runs about the set's centre).
    # Directions that are no hull edge enclose at least as much, but where
    # the area barely changes with the angle (two near-identical boxes)
    # one of them could win on rounding and tilt the box.
    n_valid = valid.sum(-1, keepdim=True).clamp(min=1)
    mx = (torch.where(valid, px, torch.zeros_like(px)).sum(-1, keepdim=True) / n_valid)
    my = (torch.where(valid, py, torch.zeros_like(py)).sum(-1, keepdim=True) / n_valid)
    rx, ry = px - mx, py - my
    extent = torch.where(valid, torch.maximum(rx.abs(), ry.abs()), torch.zeros_like(rx)).amax(-1)
    tol = 1e-6 * (1.0 + extent)[..., None, None]
    dist = (ux[..., None] * (ry[..., None, None, :] - ry[..., :, None, None])
            - uy[..., None] * (rx[..., None, None, :] - rx[..., :, None, None]))
    hull_edge = ((dist >= -tol[..., None]) | ~valid[..., None, None, :]).all(-1)
    pair_ok = pair_ok & hull_edge

    # project every point k onto every direction: (..., P_i, P_j, P_k)
    qx, qy = px[..., None, None, :], py[..., None, None, :]
    proj_u = ux[..., None] * qx + uy[..., None] * qy
    proj_v = -uy[..., None] * qx + ux[..., None] * qy
    pv = valid[..., None, None, :]
    inf = torch.full_like(proj_u, math.inf)
    u_min = torch.where(pv, proj_u, inf).amin(-1)
    u_max = torch.where(pv, proj_u, -inf).amax(-1)
    v_min = torch.where(pv, proj_v, inf).amin(-1)
    v_max = torch.where(pv, proj_v, -inf).amax(-1)
    areas = torch.where(pair_ok, (u_max - u_min) * (v_max - v_min), torch.full_like(length, math.inf))

    # Exact ties go to the first edge in glass_tpu's hull order: it starts
    # at the lowest (x, y) point and turns one way, so its edges' angles
    # rise from (-90, 90] to at most 270 degrees.
    flat = areas.flatten(-2)
    heading = torch.rad2deg(torch.atan2(ey, ex)).flatten(-2)
    order = torch.where(heading > -90.0, heading, heading + 360.0)
    tied = flat == flat.amin(-1, keepdim=True)
    best = torch.argmin(torch.where(tied, order, torch.full_like(order, math.inf)), dim=-1, keepdim=True)
    found = torch.gather(pair_ok.flatten(-2), -1, best)[..., 0]

    def pick(t):
        return torch.gather(t.flatten(-2), -1, best)[..., 0]

    zero = torch.zeros_like(px[..., 0])
    bu0 = torch.where(found, pick(ux), zero)
    bu1 = torch.where(found, pick(uy), zero)
    lo_u, hi_u = pick(u_min), pick(u_max)
    lo_v, hi_v = pick(v_min), pick(v_max)
    w = torch.where(found, hi_u - lo_u, zero)
    h = torch.where(found, hi_v - lo_v, zero)
    cu = torch.where(found, (hi_u + lo_u) / 2.0, zero)
    cv = torch.where(found, (hi_v + lo_v) / 2.0, zero)
    cx = cu * bu0 - cv * bu1
    cy = cu * bu1 + cv * bu0
    # Angle of the "width" edge: in image coordinates (y down) the XYWHA
    # convention measures CCW angles, i.e. -atan2(dy, dx) in array terms.
    angle = -torch.atan2(bu1, bu0) * 180.0 / math.pi
    return cx, cy, w, h, angle


def polygons_to_rotated_boxes(
    polygons: torch.Tensor,
    orientations: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fit min-area rotated boxes to polygons, disambiguated by orientation.

    Mirrors reference ``post_processor_rotated_boxes.py:253-286``: rotate the
    fitted rectangle's (w, h, angle) so the final angle is within 45 degrees
    of the requested orientation angle.

    Args:
        polygons: (N, P, 2) point sets.
        orientations: (N,) desired angles in degrees.
        valid: optional (N, P) point masks.
    """
    cx, cy, w, h, angle = min_area_rect(polygons, valid)
    diff = normalize_angle(orientations.to(angle.dtype) - angle)
    # Four quadrant cases from the reference implementation.
    case90 = (diff > 45) & (diff <= 135)
    case_90 = (diff > -135) & (diff <= -45)
    case180 = (diff > 135) | (diff <= -135)
    swap = case90 | case_90
    out_w = torch.where(swap, h, w)
    out_h = torch.where(swap, w, h)
    out_angle = angle + 90.0 * case90 - 90.0 * case_90 + 180.0 * case180
    return torch.stack([cx, cy, out_w, out_h, normalize_angle(out_angle)], dim=-1)
