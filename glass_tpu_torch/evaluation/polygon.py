"""Polygon area/intersection for the evaluation protocol.

The reference leans on the GEOS-backed ``Polygon3``/shapely packages; here
convex-convex intersections are exact (Sutherland–Hodgman) and potentially
concave pairs fall back to rasterized IoU at sub-pixel resolution — well
within the tolerance of the protocol's 0.5 IoU threshold.  A copy of
``glass_tpu/evaluation/polygon.py`` over the port's own native library.
"""

from __future__ import annotations

import numpy as np
import cv2


def polygon_area(points: np.ndarray) -> float:
    x, y = points[:, 0], points[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)))


def is_convex(points: np.ndarray) -> bool:
    n = len(points)
    if n < 4:
        return True
    d = np.diff(np.vstack([points, points[:2]]), axis=0)
    cross = d[:-1, 0] * d[1:, 1] - d[:-1, 1] * d[1:, 0]
    pos, neg = (cross > 1e-9).any(), (cross < -1e-9).any()
    return not (pos and neg)


def _clip(subject: np.ndarray, clip_poly: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman; clip polygon must be convex."""
    # Ensure counter-clockwise clip orientation for a consistent inside test.
    area2 = np.dot(clip_poly[:, 0], np.roll(clip_poly[:, 1], -1)) - np.dot(
        np.roll(clip_poly[:, 0], -1), clip_poly[:, 1]
    )
    if area2 < 0:
        clip_poly = clip_poly[::-1]
    out = list(subject)
    n = len(clip_poly)
    for i in range(n):
        if not out:
            return np.zeros((0, 2))
        a, b = clip_poly[i], clip_poly[(i + 1) % n]
        ba = b - a
        new_out = []
        prev = out[-1]
        s_prev = ba[0] * (prev[1] - a[1]) - ba[1] * (prev[0] - a[0])
        for cur in out:
            s_cur = ba[0] * (cur[1] - a[1]) - ba[1] * (cur[0] - a[0])
            if (s_cur >= 0) != (s_prev >= 0):
                denom = s_prev - s_cur
                t = s_prev / denom if abs(denom) > 1e-12 else 0.0
                new_out.append(prev + t * (cur - prev))
            if s_cur >= 0:
                new_out.append(cur)
            prev, s_prev = cur, s_cur
        out = new_out
    return np.asarray(out) if out else np.zeros((0, 2))


def _raster_intersection(p: np.ndarray, q: np.ndarray) -> float:
    pts = np.vstack([p, q])
    x0, y0 = pts.min(axis=0)
    x1, y1 = pts.max(axis=0)
    w, h = x1 - x0, y1 - y0
    if w <= 0 or h <= 0:
        return 0.0
    # Target ~800px on the longer side: boundary-inclusion bias stays well
    # under the protocol's matching tolerance even for small regions.
    scale = float(np.clip(800.0 / max(w, h), 0.25, 128.0))
    gw, gh = max(int(w * scale) + 2, 2), max(int(h * scale) + 2, 2)
    mp = np.zeros((gh, gw), np.uint8)
    mq = np.zeros((gh, gw), np.uint8)
    pp = np.round((p - [x0, y0]) * scale).astype(np.int32)
    qq = np.round((q - [x0, y0]) * scale).astype(np.int32)
    cv2.fillPoly(mp, [pp], 1)
    cv2.fillPoly(mq, [qq], 1)
    return float(np.logical_and(mp, mq).sum()) / (scale * scale)


def _native():
    from ..native import load_polyclip

    return load_polyclip()


def polygon_intersection_area(p: np.ndarray, q: np.ndarray) -> float:
    p = np.asarray(p, np.float64).reshape(-1, 2)
    q = np.asarray(q, np.float64).reshape(-1, 2)
    if len(p) < 3 or len(q) < 3:
        return 0.0
    lib = _native()
    if lib is not None:
        # Exact for arbitrary simple polygons (signed fan triangulation).
        return float(lib.intersection_area(p, q))
    if is_convex(p) and is_convex(q):
        inter = _clip(p, q)
        return polygon_area(inter) if len(inter) >= 3 else 0.0
    # Concave pairs without the native library: rasterized fallback — the
    # Sutherland–Hodgman clip is only exact for convex clip regions.
    return _raster_intersection(p, q)


def pairwise_polygon_iou(polys_p, polys_q) -> np.ndarray:
    """(list of (*,2)) x (list of (*,2)) -> (P, Q) IoU matrix.

    Uses the native batched path when available (one C call for the whole
    matrix — the per-image hot loop of dataset evaluation).
    """
    lib = _native()
    if lib is not None and polys_p and polys_q:
        return lib.pairwise_iou(
            [np.asarray(p, np.float64).reshape(-1, 2) for p in polys_p],
            [np.asarray(q, np.float64).reshape(-1, 2) for q in polys_q],
        )
    out = np.zeros((len(polys_p), len(polys_q)))
    for i, p in enumerate(polys_p):
        for j, q in enumerate(polys_q):
            out[i, j] = polygon_iou(p, q)
    return out


def polygon_iou(p: np.ndarray, q: np.ndarray) -> float:
    inter = polygon_intersection_area(p, q)
    union = polygon_area(np.asarray(p).reshape(-1, 2)) + polygon_area(
        np.asarray(q).reshape(-1, 2)
    ) - inter
    return inter / union if union > 1e-9 else 0.0
