"""On-device word-box merge post-processing.

Counterpart of ``glass_tpu/postprocess/device_merge.py``.  The reference's
merge-until-fixpoint loop (``post_processor_rotated_boxes.py:108-184``)
ping-pongs between CUDA IoA, CPU ``cv2.minAreaRect`` per box and CUDA NMS
every iteration.  Here the same fixpoint runs on the device over the
fixed-capacity detection set:

* pair gating (IoA, height ratio, angle difference, valid scores) as dense
  (D, D) masks,
* merged boxes via the batched min-area rectangle over the union of both
  boxes' vertices (``ops.min_area_rect``), orientation disambiguated like the
  reference (including its radians-as-degrees angle selection quirk),
* suppression via the rotated NMS of ``ops.nms_rotated``,
* glass_tpu's bounded ``lax.while_loop`` becomes a Python loop with the same
  bound (``max_iters``) and the same early exit: it stops after the first
  iteration in which no box had a partner (one host read per iteration).

D <= 128 on the eval path, so every iteration is a few dense programs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops.boxes import boxes_to_polygons, normalize_angle
from ..ops.iou_rotated import pairwise_ioa_rotated
from ..ops.min_area_rect import polygons_to_rotated_boxes
from ..ops.nms_rotated import nms_rotated_mask

MINIMAL_IOA_THRESH = 0.01


def _merge_pairs(boxes, scores, pair_mask):
    """For each box i, merge with its first partner j (if any).

    The reference merges every valid (i, j) pair per iteration by writing
    the merged box into both slots; iterating the fixpoint with one partner
    per box per iteration reaches the same fixpoint (subsequent iterations
    pick up remaining partners), as glass_tpu does.
    """
    d = boxes.shape[0]
    has_partner = pair_mask.any(dim=1)
    # the first True column (jnp.argmax of a bool row); 0 for an empty row
    cols = torch.arange(d, device=boxes.device).expand(d, d)
    partner = torch.where(pair_mask, cols, torch.full_like(cols, d)).amin(dim=1)
    partner = torch.where(has_partner, partner, torch.zeros_like(partner))

    own_poly = boxes_to_polygons(boxes)                                  # (D, 4, 2)
    union_pts = torch.cat([own_poly, own_poly[partner]], dim=1)          # (D, 8, 2)

    # Reference angle selection (post_processor_rotated_boxes.py:202-208):
    # the higher-scoring box's angle, converted to radians but consumed in
    # degrees downstream — replicated verbatim.
    own_better = scores >= scores[partner]
    merged_angle = torch.where(own_better, boxes[:, 4], boxes[partner, 4]) * math.pi / 180.0

    merged = polygons_to_rotated_boxes(union_pts, merged_angle)
    return torch.where(has_partner[:, None], merged, boxes), has_partner


def _gate(boxes, scores, valid, ioa_threshold, height_ratio_thresh, max_angle_diff, valid_score):
    ioa = pairwise_ioa_rotated(boxes, boxes)
    eye = torch.eye(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    ioa = torch.where(eye, torch.zeros_like(ioa), ioa)

    heights = boxes[:, 3]
    angles = boxes[:, 4]
    angle_diff = torch.abs(normalize_angle(angles[None, :] - angles[:, None]))
    similar_angle = (angle_diff < max_angle_diff) | (angle_diff > 180.0 - max_angle_diff)
    hr = heights[None, :] / torch.clamp(heights[:, None], min=1e-6)
    similar_height = (hr > height_ratio_thresh) & (hr < 1.0 / (height_ratio_thresh + 1e-6))
    score_ok = (scores[:, None] >= valid_score) & (scores[None, :] >= valid_score)
    both_valid = valid[:, None] & valid[None, :]
    return (ioa >= ioa_threshold) & similar_angle & similar_height & score_ok & both_valid


def merge_intersecting_boxes_device(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    ioa_threshold: float = 0.3,
    height_ratio_thresh: float = 0.35,
    max_angle_diff: float = 15.0,
    valid_score: float = 0.15,
    max_iters: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixpoint merge over a padded (D,) detection set, on the tensors'
    device.

    Returns (boxes, valid): merged boxes with suppressed entries masked out.
    """
    boxes = boxes.to(torch.float32)
    scores = scores.to(torch.float32)
    it, changed = 0, True
    while changed and it < max_iters:
        pair_mask = _gate(boxes, scores, valid, ioa_threshold, height_ratio_thresh,
                          max_angle_diff, valid_score)
        merged, had_partner = _merge_pairs(boxes, scores, pair_mask)
        valid = nms_rotated_mask(merged, scores, 0.99, valid=valid)
        boxes = merged
        it += 1
        changed = bool(had_partner.any())
    return boxes, valid
