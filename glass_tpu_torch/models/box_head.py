"""Rotated Fast R-CNN box head, predictor and static-shape inference.

Counterpart of ``glass_tpu/models/box_head.py``: d2 ``FastRCNNConvFCHead``
(2 x FC) and GLASS's ``RotatedFastRCNNOutputLayers`` (class scores, rotated
deltas, 4-way cardinal orientation), then
``fast_rcnn_inference_single_image`` as masks over a fixed-capacity set:
finite filter, clip, score threshold, optional orientation overwrite,
rotated NMS and top-k.  The top-k fills all ``topk`` rows; rows past the
kept detections are the NEG_INF-masked ones, lower index first, and they
stay in the set (marked invalid) through the recognizer and mask head.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from . import layers as L
from .rpn import top_k
from ..ops.boxes import clip_rotated_boxes, overwrite_orientations_on_boxes
from ..ops.nms_rotated import NEG_INF, nms_rotated_mask


class Detections(NamedTuple):
    """Fixed-capacity per-image detection set (padded, mask-valid)."""

    boxes: torch.Tensor         # (D, 5) XYWHA
    scores: torch.Tensor        # (D,)
    classes: torch.Tensor       # (D,) int32
    orientations: torch.Tensor  # (D, 2): [argmax orientation, prob]
    valid: torch.Tensor         # (D,) bool


class FastRCNNConvFCHead(nn.Module):
    def __init__(self, in_features: int, fc_dim: int = 2048):
        super().__init__()
        self.fc1 = nn.Linear(in_features, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (R, ph, pw, C) pooled features -> (R, FC_DIM); flattened in
        PyTorch's NCHW order, as the released checkpoints expect."""
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        x = L.relu(L.linear(x, self.fc1.weight, self.fc1.bias))
        return L.relu(L.linear(x, self.fc2.weight, self.fc2.bias))


class RotatedFastRCNNOutputLayers(nn.Module):
    def __init__(self, in_features: int, num_classes: int = 1, orientation_on: bool = True):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes + 1)
        self.bbox_pred = nn.Linear(in_features, num_classes * 5)
        if orientation_on:
            self.orientation_pred = nn.Linear(in_features, 4)

    def forward(self, x: torch.Tensor):
        """-> (scores (R, K+1), deltas (R, 5K), orientation logits (R, 4) | None)."""
        scores = L.linear(x, self.cls_score.weight, self.cls_score.bias)
        deltas = L.linear(x, self.bbox_pred.weight, self.bbox_pred.bias)
        orient = None
        if hasattr(self, "orientation_pred"):
            orient = L.linear(x, self.orientation_pred.weight, self.orientation_pred.bias)
        return scores, deltas, orient


def fast_rcnn_inference_single_image(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    orientation_logits,
    proposal_valid: torch.Tensor,
    image_size: Tuple[float, float],
    score_thresh: float,
    nms_thresh: float,
    topk: int,
    apply_orientation_to_boxes: bool = True,
) -> Detections:
    """boxes (R, 5) decoded class-0 boxes, scores (R, K+1) probabilities,
    orientation_logits (R, 4) or None, proposal_valid (R,)."""
    fg_scores = scores[:, 0]
    if orientation_logits is not None:
        orient_probs = torch.softmax(orientation_logits, dim=-1)
        orient_idx = torch.argmax(orient_probs, dim=-1)
        orient_score = torch.amax(orient_probs, dim=-1)
        orientations = torch.stack([orient_idx.to(fg_scores.dtype), orient_score], dim=-1)
        if apply_orientation_to_boxes:
            boxes = overwrite_orientations_on_boxes(boxes, orient_idx)
    else:
        orientations = torch.zeros((boxes.shape[0], 2), dtype=fg_scores.dtype, device=boxes.device)

    finite = torch.all(torch.isfinite(boxes), dim=-1) & torch.isfinite(fg_scores)
    boxes = torch.where(finite[:, None], boxes, torch.zeros_like(boxes))
    boxes = clip_rotated_boxes(boxes, image_size)

    valid = proposal_valid & finite & (fg_scores > score_thresh)
    keep = nms_rotated_mask(boxes, fg_scores, nms_thresh, valid=valid, max_keep=topk)
    masked = torch.where(keep, fg_scores, torch.full_like(fg_scores, NEG_INF))
    top_scores, top_idx = top_k(masked, topk)
    sel_valid = top_scores > NEG_INF / 2
    return Detections(
        boxes=boxes[top_idx],
        scores=torch.where(sel_valid, top_scores, torch.zeros_like(top_scores)),
        classes=torch.zeros((topk,), dtype=torch.int32, device=boxes.device),
        orientations=orientations[top_idx],
        valid=sel_valid,
    )
