"""Box matching and balanced sampling.

Counterpart of ``glass_tpu/train/matcher.py``:

* ``matcher_assign``: detectron2 ``Matcher`` on a (G, P) quality matrix,
* ``rpn_label_anchors``: RRPN anchor labelling at anchor scale (about 2 M
  anchors at 1440 px, where a dense G x A rotated IoU cannot fit).  It keeps
  glass_tpu's exact (scan) matcher's idea: a provable upper bound of the
  rotated IoU selects the anchors that can reach the ignore threshold, the
  exact rotated IoU runs on those only, and a second round rescues each weak
  gt's best anchors.  PyTorch takes dynamic shapes, so the candidate sets
  are ``nonzero`` lists with no capacity: nothing overflows, and the labels
  and matched indices are those of glass_tpu's matcher whenever its pools
  do not overflow.  Every valid ``TPU.MATCH_BACKEND`` runs this matcher.
* ``subsample_labels`` / ``subsample_labels_idx``: d2's balanced fg/bg
  sampling as "uniform priorities, then top-k", with the priorities given
  by the caller (``train_step.Priorities``).

Tie order: every top-k is ``models.rpn.top_k`` (a stable descending sort,
lower index first), as ``lax.top_k``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..models.rpn import top_k
from ..ops.iou_rotated import pairwise_iou_rotated

# Anchors a block of the bound pass holds (peak memory ~ 20 x 32 x this x 4 B).
_BOUND_ANCHORS = 1 << 18
_BOUND_GTS = 32


def matcher_assign(quality: torch.Tensor, thresholds, labels, allow_low_quality: bool = False):
    """d2 Matcher on a (G, P) quality matrix -> (matched_idx (P,), match_labels (P,))."""
    matched_vals = torch.amax(quality, dim=0)
    matched_idx = torch.argmax(quality, dim=0)  # the first maximum, as jnp.argmax
    match_labels = torch.full((quality.shape[1],), labels[0], dtype=torch.int32, device=quality.device)
    edges = list(thresholds)
    for lab, low, high in zip(labels, [0.0] + edges, edges + [float("inf")]):
        in_range = (matched_vals >= low) & (matched_vals < high)
        match_labels = torch.where(in_range, torch.full_like(match_labels, lab), match_labels)
    if allow_low_quality:
        best_per_gt = torch.amax(quality, dim=1, keepdim=True)
        is_best = (quality >= best_per_gt - 1e-5) & (best_per_gt > 1e-5)
        match_labels = torch.where(is_best.any(dim=0), torch.ones_like(match_labels), match_labels)
    return matched_idx, match_labels


def pairwise_iou_upper_bound(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(M, 5) x (N, 5) XYWHA -> (M, N) provable upper bound of the rotated
    IoU (glass_tpu's oriented-slab bound, in its operation order): the
    intersection lies inside the overlap of the two boxes' projections on
    either box's axes and inside either box, so with ``m`` the least of
    those areas, ``IoU <= m / (S1 + S2 - m)``."""
    t1 = torch.deg2rad(boxes1[:, 4])
    t2 = torch.deg2rad(boxes2[:, 4])
    c1, s1 = torch.cos(t1), torch.sin(t1)
    c2, s2 = torch.cos(t2), torch.sin(t2)
    cd = torch.abs(c1[:, None] * c2[None, :] + s1[:, None] * s2[None, :])
    sd = torch.abs(s1[:, None] * c2[None, :] - c1[:, None] * s2[None, :])
    w1, h1 = boxes1[:, 2] * 0.5, boxes1[:, 3] * 0.5
    w2, h2 = boxes2[:, 2] * 0.5, boxes2[:, 3] * 0.5
    cx1, cy1 = boxes1[:, 0], boxes1[:, 1]
    cx2, cy2 = boxes2[:, 0], boxes2[:, 1]

    def frame_bound(ext_u, ext_v, proj_u, proj_v, r_u, r_v):
        ov_u = torch.clamp(torch.minimum(ext_u, proj_u + r_u) - torch.maximum(-ext_u, proj_u - r_u), min=0.0)
        ov_v = torch.clamp(torch.minimum(ext_v, proj_v + r_v) - torch.maximum(-ext_v, proj_v - r_v), min=0.0)
        return ov_u * ov_v

    du = (cx2[None, :] - cx1[:, None]) * c1[:, None] - (cy2[None, :] - cy1[:, None]) * s1[:, None]
    dv = (cx2[None, :] - cx1[:, None]) * s1[:, None] + (cy2[None, :] - cy1[:, None]) * c1[:, None]
    r2_u = w2[None, :] * cd + h2[None, :] * sd
    r2_v = w2[None, :] * sd + h2[None, :] * cd
    b1 = frame_bound(w1[:, None], h1[:, None], du, dv, r2_u, r2_v)

    eu = (cx1[:, None] - cx2[None, :]) * c2[None, :] - (cy1[:, None] - cy2[None, :]) * s2[None, :]
    ev = (cx1[:, None] - cx2[None, :]) * s2[None, :] + (cy1[:, None] - cy2[None, :]) * c2[None, :]
    r1_u = w1[:, None] * cd + h1[:, None] * sd
    r1_v = w1[:, None] * sd + h1[:, None] * cd
    b2 = frame_bound(w2[None, :], h2[None, :], eu, ev, r1_u, r1_v)

    area1 = boxes1[:, 2] * boxes1[:, 3]
    area2 = boxes2[:, 2] * boxes2[:, 3]
    bound = torch.minimum(b1, b2)
    bound = torch.minimum(bound, torch.minimum(area1[:, None], area2[None, :]))
    denom = torch.clamp(area1[:, None] + area2[None, :] - bound, min=1e-12)
    return bound / denom


def _bound_reach(gts: torch.Tensor, anchors: torch.Tensor, thr) -> torch.Tensor:
    """(A,) bool: some gt's bound reaches its threshold (thr: float or (M,))."""
    out = torch.zeros(anchors.shape[0], dtype=torch.bool, device=anchors.device)
    if gts.shape[0] == 0:
        return out
    thr = torch.as_tensor(thr, dtype=torch.float32, device=anchors.device).expand(gts.shape[0])
    for a0 in range(0, anchors.shape[0], _BOUND_ANCHORS):
        a = anchors[a0:a0 + _BOUND_ANCHORS]
        hit = out[a0:a0 + _BOUND_ANCHORS]
        for g0 in range(0, gts.shape[0], _BOUND_GTS):
            ub = pairwise_iou_upper_bound(gts[g0:g0 + _BOUND_GTS], a)
            hit |= (ub >= thr[g0:g0 + _BOUND_GTS, None]).any(dim=0)
    return out


def _pool_iou(gt_boxes: torch.Tensor, valid_rows: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(G, P) exact rotated IoU with the rows of invalid gts zero (only the
    valid rows are computed)."""
    iou = torch.zeros((gt_boxes.shape[0], boxes.shape[0]), dtype=torch.float32, device=boxes.device)
    if valid_rows.numel() and boxes.shape[0]:
        iou[valid_rows] = pairwise_iou_rotated(gt_boxes[valid_rows], boxes)
    return iou


def rpn_label_anchors(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors: torch.Tensor,
                      thresholds: Tuple[float, float] = (0.3, 0.7)):
    """RRPN anchor labelling before subsampling.

    Returns labels (A,) in {1 fg, 0 bg, -1 ignore} with low-quality matches
    applied, matched_gt_idx (A,) (the argmax gt of an anchor that reached
    the exact pass, else 0, as glass_tpu) and the diagnostics dict
    (``matcher_pool_dropped`` and ``matcher_weak_dropped``: 0, there are no
    pools here; the weak-gt rescue keeps glass_tpu's cap of
    ``min(G, max(32, G // 4))`` gts and counts those beyond it).
    """
    lo, hi = thresholds
    g, a = gt_boxes.shape[0], anchors.shape[0]
    dev = anchors.device
    gt_boxes = gt_boxes.to(torch.float32)
    valid_rows = torch.nonzero(gt_valid).reshape(-1)
    # Round 1: anchors whose bound reaches `lo` (every other one is exact bg);
    # the 1e-4 margin absorbs f32 rounding of the bound itself.
    flags1 = _bound_reach(gt_boxes[valid_rows], anchors, lo - 1e-4)
    idx1 = torch.nonzero(flags1).reshape(-1)
    iou1 = _pool_iou(gt_boxes, valid_rows, anchors[idx1])
    best1 = iou1.amax(dim=1) if idx1.numel() else torch.zeros(g, device=dev)
    # Round 2: every anchor that could still beat a weak gt's round-1 best.
    weak = (best1 < lo) & gt_valid
    weak_cap = min(g, max(32, g // 4))
    w_idx = torch.nonzero(weak).reshape(-1)[:weak_cap]
    weak_thr = torch.clamp(best1[w_idx] - 1e-4, min=1e-4)
    flags2 = _bound_reach(gt_boxes[w_idx], anchors, weak_thr) & ~flags1
    idx2 = torch.nonzero(flags2).reshape(-1)
    iou2 = _pool_iou(gt_boxes, valid_rows, anchors[idx2])
    diag = {
        "matcher_pool_dropped": torch.zeros((), device=dev),
        "matcher_weak_dropped": torch.clamp(weak.sum() - weak_cap, min=0).to(torch.float32),
    }
    iou = torch.cat([iou1, iou2], dim=1)
    pool = torch.cat([idx1, idx2])
    labels = torch.zeros(a, dtype=torch.int32, device=dev)
    matched = torch.zeros(a, dtype=torch.int64, device=dev)
    if pool.numel() == 0:
        return labels, matched, diag
    col_max, _ = torch.max(iou, dim=0)
    col_arg = torch.argmax(iou, dim=0)
    matched[pool] = col_arg
    pool_labels = torch.where(col_max >= hi, 1, torch.where(col_max >= lo, -1, 0)).to(torch.int32)
    # Low-quality matches: each gt's best anchors become foreground.
    best_per_gt = iou.amax(dim=1, keepdim=True)
    is_best = (iou >= best_per_gt - 1e-5) & (best_per_gt > 1e-5)
    pool_labels = torch.where(is_best.any(dim=0), torch.ones_like(pool_labels), pool_labels)
    labels[pool] = pool_labels
    return labels, matched, diag


def _pick(mask, count, cap: int, priority):
    """The ``cap`` highest priorities among ``mask`` (others -1): indices and
    whether each is one of the first ``count``."""
    n = mask.shape[0]
    cap = min(cap, n)
    pri = torch.where(mask, priority, torch.full_like(priority, -1.0))
    vals, idx = top_k(pri, cap)
    sel = (torch.arange(cap, device=mask.device) < count) & (vals >= 0.0)
    return idx, sel


def _counts(labels, num_samples: int, positive_fraction: float):
    is_pos, is_neg = labels == 1, labels == 0
    max_pos = int(num_samples * positive_fraction)
    num_pos = torch.clamp(is_pos.sum(), max=max_pos)
    num_neg = torch.minimum(is_neg.sum(), num_samples - num_pos)
    return is_pos, is_neg, max_pos, num_pos, num_neg


def subsample_labels(labels, num_samples: int, positive_fraction: float, pos_priority, neg_priority):
    """d2 ``subsample_labels`` as boolean masks (pos_mask, neg_mask).

    labels (N,): 1 positive, 0 negative, -1 ignore.  ``*_priority`` (N,)
    uniform draws; each class keeps its highest-priority members."""
    n = labels.shape[0]
    is_pos, is_neg, max_pos, num_pos, num_neg = _counts(labels, num_samples, positive_fraction)

    def mask_of(mask, count, cap, pri):
        out = torch.zeros(n, dtype=torch.bool, device=labels.device)
        if min(cap, n) <= 0:
            return out
        idx, sel = _pick(mask, count, cap, pri)
        return out.index_put((idx,), sel)

    return (mask_of(is_pos, num_pos, max_pos, pos_priority),
            mask_of(is_neg, num_neg, num_samples, neg_priority))


def subsample_labels_idx(labels, num_samples: int, positive_fraction: float, pos_priority,
                         neg_priority):
    """Index-set form of ``subsample_labels``: (pos_idx, pos_valid, neg_idx,
    neg_valid), the same selection."""
    is_pos, is_neg, max_pos, num_pos, num_neg = _counts(labels, num_samples, positive_fraction)
    pos_idx, pos_val = _pick(is_pos, num_pos, max_pos, pos_priority)
    neg_idx, neg_val = _pick(is_neg, num_neg, num_samples, neg_priority)
    return pos_idx, pos_val, neg_idx, neg_val


def select_topk_mask(mask: torch.Tensor, k: int, priority: torch.Tensor):
    """Up to ``k`` True entries of ``mask`` by descending priority ->
    (indices (k,), valid (k,)); the slots beyond them hold the lowest
    unselected indices (``lax.top_k``'s order for the -inf rows)."""
    n = mask.shape[0]
    pri = torch.where(mask, priority.to(torch.float32), torch.full_like(priority, -math.inf, dtype=torch.float32))
    if k > n:
        pri = torch.cat([pri, torch.full((k - n,), -math.inf, device=pri.device)])
    vals, idx = top_k(pri, k)
    return torch.clamp(idx, max=n - 1), vals > -math.inf
