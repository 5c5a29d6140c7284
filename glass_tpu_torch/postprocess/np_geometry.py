"""Host-side (numpy/cv2) rotated-box geometry for the post-processor.

The post-processing stage operates on at most ``DETECTIONS_PER_IMAGE`` (100)
boxes per image, so a host numpy implementation is cheap; it exists to
replicate the reference semantics exactly (``cv2.minAreaRect`` included,
reference ``post_processor_rotated_boxes.py:253-286``).  Device counterparts
live in ``glass_tpu_torch.ops``.

The rotated IoU's clip runs in the native library (``native/polyclip.cpp``,
one call a matrix, bit for bit the numpy body kept here) whenever it loads;
the numpy clip is the path without it.
"""

from __future__ import annotations

import numpy as np
import cv2

from ..native import load_polyclip
from ..utils import trace


def boxes_to_polygons_np(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) XYWHA -> (N, 4, 2); reference post_processor_rotated_boxes.py:219-250."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 4, 2), boxes.dtype if boxes.size else np.float32)
    cx, cy, w, h, a = boxes.T
    t = (-a / 180.0) * np.pi
    sin_t, cos_t = np.sin(t), np.cos(t)
    polygons = np.zeros((n, 4, 2), boxes.dtype)
    polygons[:, 0, 0] = cx + (h * sin_t - w * cos_t) / 2
    polygons[:, 1, 0] = cx + (h * sin_t + w * cos_t) / 2
    polygons[:, 2, 0] = cx - (h * sin_t - w * cos_t) / 2
    polygons[:, 3, 0] = cx - (h * sin_t + w * cos_t) / 2
    polygons[:, 0, 1] = cy - (h * cos_t + w * sin_t) / 2
    polygons[:, 1, 1] = cy - (h * cos_t - w * sin_t) / 2
    polygons[:, 2, 1] = cy + (h * cos_t + w * sin_t) / 2
    polygons[:, 3, 1] = cy + (h * cos_t - w * sin_t) / 2
    return polygons


def _convex_quad_intersection_area(p: np.ndarray, q: np.ndarray) -> float:
    """Sutherland–Hodgman intersection area of two convex quads (4, 2)."""
    poly = list(p)
    for i in range(4):
        a, b = q[i], q[(i + 1) % 4]
        ba = b - a
        if not poly:
            return 0.0
        new_poly = []
        prev = poly[-1]
        s_prev = ba[0] * (prev[1] - a[1]) - ba[1] * (prev[0] - a[0])
        for cur in poly:
            s_cur = ba[0] * (cur[1] - a[1]) - ba[1] * (cur[0] - a[0])
            if (s_cur >= 0) != (s_prev >= 0):
                denom = s_prev - s_cur
                t = s_prev / denom if abs(denom) > 1e-12 else 0.0
                new_poly.append(prev + t * (cur - prev))
            if s_cur >= 0:
                new_poly.append(cur)
            prev, s_prev = cur, s_cur
        poly = new_poly
    if len(poly) < 3:
        return 0.0
    arr = np.asarray(poly)
    x, y = arr[:, 0], arr[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))


def _quad_intersection_areas_batch(P: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """Vectorized Sutherland–Hodgman over K polygon pairs.

    P, Q: (K, 4, 2) convex quads (float64) -> (K,) intersection areas.
    Same clipping rules (including the |denom| > 1e-12 guard) as the scalar
    ``_convex_quad_intersection_area``; a convex quad clipped by 4
    half-planes has at most 8 vertices, so a fixed capacity-8 buffer with a
    per-pass compaction keeps everything dense numpy.

    Rounding can break that bound: where the quads share an edge (the same
    rectangle given as (w, h, a) and (h, w, a + 90)) the signs of vertices
    on the clip line alternate and a pass keeps more than 8 vertices, which
    glass_tpu's copy of this function indexes past its buffer (an
    IndexError, met with fp16 serving outputs on the card).  Those pairs
    take the scalar clip, which has no buffer.
    """
    k = len(P)
    if k == 0:
        return np.zeros((0,), np.float64)
    cap = 8
    verts = np.zeros((k, cap, 2), np.float64)
    verts[:, :4] = P
    nv = np.full(k, 4, np.int64)
    slots = np.arange(cap)
    overflow = np.zeros(k, bool)

    for i in range(4):
        a = Q[:, i]                      # (K, 2)
        ba = Q[:, (i + 1) % 4] - a
        valid = slots[None, :] < nv[:, None]
        s = (
            ba[:, :1] * (verts[..., 1] - a[:, 1:2])
            - ba[:, 1:2] * (verts[..., 0] - a[:, :1])
        )                                # (K, cap)
        prev_idx = (slots[None, :] - 1) % np.maximum(nv[:, None], 1)
        prev = np.take_along_axis(verts, prev_idx[..., None], axis=1)
        s_prev = np.take_along_axis(s, prev_idx, axis=1)
        inside = s >= 0
        crossing = (inside != (s_prev >= 0)) & valid
        denom = s_prev - s
        t = np.where(np.abs(denom) > 1e-12, s_prev / np.where(denom == 0, 1.0, denom), 0.0)
        ipt = prev + t[..., None] * (verts - prev)

        # Scalar ordering: [intersection-before-cur, cur] for each cur slot.
        out = np.zeros((k, 2 * cap, 2), np.float64)
        keep = np.zeros((k, 2 * cap), bool)
        out[:, 0::2] = ipt
        keep[:, 0::2] = crossing
        out[:, 1::2] = verts
        keep[:, 1::2] = inside & valid
        order = np.argsort(~keep, axis=1, kind="stable")
        verts = np.take_along_axis(out, order[..., None], axis=1)[:, :cap]
        nv = keep.sum(axis=1)
        overflow |= nv > cap
        nv = np.minimum(nv, cap)

    valid = slots[None, :] < nv[:, None]
    v = np.where(valid[..., None], verts, 0.0)
    nxt_idx = (slots[None, :] + 1) % np.maximum(nv[:, None], 1)
    nxt = np.take_along_axis(v, nxt_idx[..., None], axis=1)
    cross = v[..., 0] * nxt[..., 1] - nxt[..., 0] * v[..., 1]
    area = np.where(nv >= 3, 0.5 * np.abs(np.where(valid, cross, 0.0).sum(axis=1)), 0.0)
    for r in np.nonzero(overflow)[0]:
        area[r] = _convex_quad_intersection_area(P[r], Q[r])
    return area


def pairwise_iou_rotated_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    p1 = boxes_to_polygons_np(np.asarray(boxes1, np.float64))
    p2 = boxes_to_polygons_np(np.asarray(boxes2, np.float64))
    a1 = np.asarray(boxes1[:, 2] * boxes1[:, 3], np.float64)
    a2 = np.asarray(boxes2[:, 2] * boxes2[:, 3], np.float64)
    n, m = len(boxes1), len(boxes2)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    lib = load_polyclip()
    if lib is None:
        return _pairwise_iou_quads_numpy(p1, a1, p2, a2)
    out, overflow = lib.pairwise_iou_quads(p1, a1, p2, a2)
    trace.count("glass.post.merge.fallback_pairs", len(overflow))
    if len(overflow):  # quads sharing an edge: the scalar clip, as in the numpy body
        ii, jj = np.divmod(overflow, m)
        out[ii, jj] = _iou_from_inter(
            np.array([_convex_quad_intersection_area(p1[i], p2[j]) for i, j in zip(ii, jj)]),
            a1[ii], a2[jj],
        )
    return out


def _iou_from_inter(inter: np.ndarray, a1: np.ndarray, a2: np.ndarray) -> np.ndarray:
    union = a1 + a2 - inter
    vals = np.where(union > 1e-12, inter / np.where(union == 0, 1.0, union), 0.0)
    return vals.astype(np.float32)


def _pairwise_iou_quads_numpy(p1, a1, p2, a2) -> np.ndarray:
    """The numpy body of ``pairwise_iou_rotated_np`` on its float64 polygons
    and areas: the path without the native library, and its test twin."""
    out = np.zeros((len(p1), len(p2)), np.float32)
    # AABB prefilter: trivially-disjoint pairs never enter the clipper.
    lo1, hi1 = p1.min(axis=1), p1.max(axis=1)
    lo2, hi2 = p2.min(axis=1), p2.max(axis=1)
    overlap = (
        (lo1[:, None, 0] <= hi2[None, :, 0]) & (lo2[None, :, 0] <= hi1[:, None, 0])
        & (lo1[:, None, 1] <= hi2[None, :, 1]) & (lo2[None, :, 1] <= hi1[:, None, 1])
        & (a1[:, None] > 1e-14) & (a2[None, :] > 1e-14)
    )
    ii, jj = np.nonzero(overlap)
    if len(ii) == 0:
        return out
    trace.count("glass.post.merge.fallback_pairs", len(ii))
    inter = _quad_intersection_areas_batch(p1[ii], p2[jj])
    out[ii, jj] = _iou_from_inter(inter, a1[ii], a2[jj])
    return out


def _ioa_from_iou(iou: np.ndarray, boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """IoA via the reference's algebraic identity (structures/boxes.py:23-48)."""
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    inter = (a1 + a2) * iou / (1.0 + iou)
    min_area = np.minimum(a1, a2)
    with np.errstate(divide="ignore", invalid="ignore"):
        ioa = np.where(min_area > 1e-12, inter / min_area, 0.0)
    return ioa.astype(np.float32)


def pairwise_ioa_rotated_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    return _ioa_from_iou(pairwise_iou_rotated_np(boxes1, boxes2), boxes1, boxes2)


def nms_rotated_np(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy rotated NMS -> kept indices in score order."""
    return _nms_rotated_with_iou(boxes, scores, iou_threshold)[0]


def _nms_rotated_with_iou(boxes, scores, iou_threshold):
    """``nms_rotated_np``'s kept indices, and the IoU of ``boxes[keep]``
    with itself: the rows and columns of the kept positions of the matrix
    NMS computed, every entry the same pair of the same boxes, so the same
    bits as ``pairwise_iou_rotated_np(boxes[keep], boxes[keep])``."""
    order = np.argsort(-scores, kind="stable")
    iou = pairwise_iou_rotated_np(boxes[order], boxes[order])
    n = len(order)
    suppressed = np.zeros(n, bool)
    kept = []
    for i in range(n):
        if suppressed[i]:
            continue
        kept.append(i)
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = False
    kept = np.asarray(kept, np.int64)
    return order[kept].astype(np.int64), iou[np.ix_(kept, kept)]


def polygons_to_rotated_boxes_np(
    polygons: np.ndarray, orientations: np.ndarray | None = None
) -> np.ndarray:
    """cv2.minAreaRect refit with orientation-consistent disambiguation.

    Exact port of reference ``post_processor_rotated_boxes.py:253-286``.
    """
    out = np.zeros((len(polygons), 5), np.float32)
    for i, polygon in enumerate(np.asarray(polygons, np.float32)):
        center, shape, angle = cv2.minAreaRect(polygon)
        angle = 90 - angle  # flip to the XYWHA angle convention
        diff_angle = (orientations[i] - angle) if orientations is not None else 0.0
        diff_angle = (diff_angle + 180) % 360 - 180
        if -45 < diff_angle <= 45:
            width, height = shape[1], shape[0]
        elif 45 < diff_angle <= 135:
            width, height = shape[0], shape[1]
            angle += 90
        elif -135 < diff_angle <= -45:
            width, height = shape[0], shape[1]
            angle -= 90
        else:
            width, height = shape[1], shape[0]
            angle += 180
        angle = (angle + 180) % 360 - 180
        out[i] = [center[0], center[1], width, height, angle]
    return out
