"""Word-box post-processing: merge fixpoint, thresholds, polygons.

Re-implements reference ``glass/postprocess/post_processor_rotated_boxes.py``
and ``post_processor_academic.py`` semantics on host numpy:

* ``PostProcessorRotatedBoxes``: small-box filter -> valid-score filter ->
  merge-until-fixpoint (IoA >= 0.3, height ratio in (0.35, 1/0.35),
  angle diff < 15 deg, both scores >= VALID) with cv2.minAreaRect refits and
  NMS(0.99) per iteration -> detect-threshold -> attach polygons,
* ``PostProcessorAcademic``: adds text-confidence filtering, box inflation,
  IoA-based overlap dropping, and the rotated-aware ``detector_postprocess``
  rescale + mask paste.

These run on <= 100 boxes/image; the heavy per-box CUDA<->CPU ping-pong of
the reference collapses to vectorized numpy here, or, with
POST_PROCESSING.ON_DEVICE, to the device fixpoint of ``device_merge.py``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..device import resolve_device
from ..native import load_polyclip
from ..structures import Instances
from ..text import TextCodec, decode_instance_texts
from ..utils import trace
from .np_geometry import (
    _ioa_from_iou,
    _nms_rotated_with_iou,
    boxes_to_polygons_np,
    nms_rotated_np,
    pairwise_ioa_rotated_np,
    pairwise_iou_rotated_np,
    polygons_to_rotated_boxes_np,
)

logger = logging.getLogger(__name__)


class PostProcessorRotatedBoxes:
    def __init__(self, cfg, device=None):
        self.skip_all = cfg.POST_PROCESSING.SKIP_ALL
        self.minimal_ioa_thresh = 0.01
        self.detect_threshold = cfg.POST_PROCESSING.DETECT_THRESHOLD
        self.min_box_dim = cfg.POST_PROCESSING.MIN_BOX_DIMENSION
        self.merge_ioa_thresh = cfg.POST_PROCESSING.MERGE_IOA_THRESH
        self.pairs_height_ratio_thresh = cfg.POST_PROCESSING.PAIRS_HEIGHT_RATIO_THRESH
        self.valid_score = cfg.POST_PROCESSING.VALID_CONFIDENCE
        self.max_angle_diff = cfg.POST_PROCESSING.MAX_ANGLE_DIFF
        # On-device merge fixpoint (postprocess/device_merge.py) instead of
        # the per-iteration host IoA/minAreaRect/NMS loop; opt-in, as in
        # glass_tpu.  It runs on ``device`` (cuda unless the caller asks for
        # the CPU; GlassRunner passes its own).
        self.on_device = bool(getattr(cfg.POST_PROCESSING, "ON_DEVICE", False))
        self.device = resolve_device(device) if self.on_device else None
        assert self.valid_score <= self.detect_threshold
        load_polyclip()  # the rotated IoU's native clip: built in set-up, not in a request

    def __call__(self, preds: Instances) -> Instances:
        if self.skip_all:
            return preds
        preds = self.filter_small_boxes(preds)
        preds = preds[np.asarray(preds.scores) >= self.valid_score]
        preds = self.merge_intersecting_boxes(
            preds, self.merge_ioa_thresh, self.pairs_height_ratio_thresh
        )
        preds = preds[np.asarray(preds.scores) >= self.detect_threshold]
        preds.pred_polygons = self.boxes_to_polygons(np.asarray(preds.pred_boxes))
        return preds

    def filter_small_boxes(self, preds: Instances) -> Instances:
        if len(preds) == 0:
            return preds
        boxes = np.asarray(preds.pred_boxes)
        min_dim = np.minimum(boxes[:, 2], boxes[:, 3])
        return preds[min_dim >= self.min_box_dim]

    def merge_intersecting_boxes(
        self, preds: Instances, ioa_threshold: float, pairs_height_ratio_thresh: float
    ) -> Instances:
        if len(preds) == 0:
            return preds
        with trace.span("glass.post.merge"):
            if self.on_device:
                return self._merge_on_device(
                    preds, ioa_threshold, pairs_height_ratio_thresh
                )
            # One IoU matrix a round: NMS's matrix of the merged boxes, at
            # the kept positions, is the next round's (the same boxes).
            iou, rounds = None, 0
            while True:
                rounds += 1
                boxes = np.asarray(preds.pred_boxes, np.float32).copy()
                scores = np.asarray(preds.scores, np.float32)
                if iou is None:
                    iou = pairwise_iou_rotated_np(boxes, boxes)
                    trace.count("glass.post.merge.matrices")
                ioa = _ioa_from_iou(iou, boxes, boxes)
                np.fill_diagonal(ioa, 0.0)
                pairs = np.argwhere(np.triu(ioa) >= self.minimal_ioa_thresh)
                if len(pairs) == 0:
                    break

                heights = boxes[:, 3]
                angles = boxes[:, 4]
                angle_diff = angles[pairs[:, 1]] - angles[pairs[:, 0]]
                angle_diff = np.abs((angle_diff + 180) % 360 - 180)
                similar_angle = (angle_diff < self.max_angle_diff) | (
                    angle_diff > (180 - self.max_angle_diff)
                )
                height_ratio = heights[pairs[:, 1]] / heights[pairs[:, 0]]
                similar_height = (pairs_height_ratio_thresh < height_ratio) & (
                    height_ratio < 1.0 / (pairs_height_ratio_thresh + 1e-6)
                )
                min_pair_score = np.minimum(scores[pairs[:, 0]], scores[pairs[:, 1]])
                valid_score = min_pair_score >= self.valid_score
                ioa_ok = ioa[pairs[:, 0], pairs[:, 1]] >= ioa_threshold

                mask = valid_score & similar_height & ioa_ok & similar_angle
                if not mask.any():
                    break

                vp = pairs[mask]
                merged = self._merge_rotated_boxes(
                    boxes[vp[:, 0]], boxes[vp[:, 1]], scores[vp[:, 0]], scores[vp[:, 1]]
                )
                boxes[vp[:, 0]] = merged
                boxes[vp[:, 1]] = merged
                preds.pred_boxes = boxes
                # d2's nms_rotated returns kept indices in descending-score
                # order, reordering the predictions — preserved here.
                keep, iou = _nms_rotated_with_iou(boxes, scores, 0.99)
                trace.count("glass.post.merge.matrices")
                preds = preds[keep]
            trace.count("glass.post.merge.rounds", rounds)
            return preds

    def _merge_on_device(
        self, preds: Instances, ioa_threshold: float, pairs_height_ratio_thresh: float
    ) -> Instances:
        """POST_PROCESSING.ON_DEVICE path: the fixpoint of
        postprocess/device_merge.py on a padded power-of-two capacity (at
        least 8), on the post-processor's device."""
        from .device_merge import merge_intersecting_boxes_device

        n = len(preds)
        cap = max(8, int(2 ** np.ceil(np.log2(n))))  # few distinct shapes
        boxes = np.zeros((cap, 5), np.float32)
        boxes[:, 2:4] = 1.0
        boxes[:n] = np.asarray(preds.pred_boxes, np.float32)
        scores = np.zeros((cap,), np.float32)
        scores[:n] = np.asarray(preds.scores, np.float32)
        valid = np.zeros((cap,), bool)
        valid[:n] = True
        dev = self.device
        out_boxes, out_valid = merge_intersecting_boxes_device(
            torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
            torch.from_numpy(valid).to(dev),
            ioa_threshold=ioa_threshold,
            height_ratio_thresh=pairs_height_ratio_thresh,
            max_angle_diff=self.max_angle_diff,
            valid_score=self.valid_score,
        )
        out_boxes = out_boxes.cpu().numpy()[:n]
        keep = out_valid.cpu().numpy()[:n]
        # Keep the host path's descending-score output ordering.
        preds.pred_boxes = out_boxes
        preds = preds[keep]
        order = np.argsort(-np.asarray(preds.scores), kind="stable")
        return preds[order]

    @classmethod
    def _merge_rotated_boxes(cls, boxes1, boxes2, scores1=None, scores2=None):
        polygons1 = boxes_to_polygons_np(boxes1)
        polygons2 = boxes_to_polygons_np(boxes2)
        angles1 = boxes1[:, 4]
        angles2 = boxes2[:, 4]
        if scores1 is not None and scores2 is not None:
            # Reference quirk (post_processor_rotated_boxes.py:204-205): the
            # winning angle is selected in *radians* but consumed as degrees.
            merged_angle = np.where(
                scores1 >= scores2, angles1 * np.pi / 180, angles2 * np.pi / 180
            )
        else:
            a1 = angles1 * np.pi / 180
            a2 = angles2 * np.pi / 180
            merged_angle = (
                np.arctan2(np.sin(a1) + np.sin(a2), np.cos(a1) + np.cos(a2)) * 180 / np.pi
            )
        polygons = np.concatenate([polygons1, polygons2], axis=1)  # (N, 8, 2)
        return polygons_to_rotated_boxes_np(polygons, orientations=merged_angle)

    @staticmethod
    def boxes_to_polygons(boxes: np.ndarray) -> np.ndarray:
        return boxes_to_polygons_np(boxes)


class PostProcessorAcademic(PostProcessorRotatedBoxes):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        self.text_threshold = cfg.POST_PROCESSING.TEXT_THRESHOLD
        self.codec = TextCodec.from_config(cfg)

    def __call__(self, preds: Instances, scale_ratio: float = 1.0, **kwargs) -> Instances:
        preds = super().__call__(preds)
        if len(preds) == 0:
            return preds
        _, text_scores, _ = decode_instance_texts(preds, self.codec)
        return preds[np.asarray(text_scores) >= self.text_threshold]

    @staticmethod
    def resize_boxes(preds: Instances, ratio: float, axis: str = "both") -> Instances:
        if len(preds) == 0:
            return preds
        boxes = np.asarray(preds.pred_boxes).copy()
        if axis in ("both", "horizontal"):
            boxes[:, 2] += ratio * boxes[:, 2]
        if axis in ("both", "vertical"):
            boxes[:, 3] += ratio * boxes[:, 3]
        preds.pred_boxes = _clip_np(boxes, preds.image_size)
        return preds

    @staticmethod
    def drop_overlapping_boxes(
        preds: Instances,
        ioa_threshold: float,
        valid_score: float,
        minimal_ioa_thresh: float = 0.01,
    ) -> Instances:
        if len(preds) == 0:
            return preds
        boxes = np.asarray(preds.pred_boxes).copy()
        scores = np.asarray(preds.scores)
        ioa = pairwise_ioa_rotated_np(boxes, boxes)
        np.fill_diagonal(ioa, 0.0)
        pairs = np.argwhere(np.triu(ioa) >= minimal_ioa_thresh)
        if len(pairs) == 0:
            return preds
        areas = boxes[:, 2] * boxes[:, 3]
        min_pair_score = np.minimum(scores[pairs[:, 0]], scores[pairs[:, 1]])
        mask = (min_pair_score >= valid_score) & (
            ioa[pairs[:, 0], pairs[:, 1]] >= ioa_threshold
        )
        if not mask.any():
            return preds
        op = pairs[mask]
        bigger = np.where(
            (areas[op[:, 0]] > areas[op[:, 1]])[:, None], boxes[op[:, 0]], boxes[op[:, 1]]
        )
        boxes[op[:, 0]] = bigger
        boxes[op[:, 1]] = bigger
        preds.pred_boxes = boxes
        keep = nms_rotated_np(boxes, scores, 0.99)
        return preds[keep]


def _clip_np(boxes: np.ndarray, image_size, clip_angle_threshold: float = 1.0):
    h_img, w_img = image_size
    out = boxes.copy()
    idx = np.abs(out[:, 4]) <= clip_angle_threshold
    x1 = np.clip(out[idx, 0] - out[idx, 2] / 2, 0, w_img)
    y1 = np.clip(out[idx, 1] - out[idx, 3] / 2, 0, h_img)
    x2 = np.clip(out[idx, 0] + out[idx, 2] / 2, 0, w_img)
    y2 = np.clip(out[idx, 1] + out[idx, 3] / 2, 0, h_img)
    out[idx, 0] = (x1 + x2) / 2
    out[idx, 1] = (y1 + y2) / 2
    out[idx, 2] = x2 - x1
    out[idx, 3] = y2 - y1
    return out


def scale_rotated_np(boxes: np.ndarray, sx: float, sy: float) -> np.ndarray:
    cx, cy, w, h, a = boxes.T.copy()
    t = np.deg2rad(a)
    c, s = np.cos(t), np.sin(t)
    return np.stack(
        [
            cx * sx,
            cy * sy,
            w * np.sqrt((sx * c) ** 2 + (sy * s) ** 2),
            h * np.sqrt((sx * s) ** 2 + (sy * c) ** 2),
            np.rad2deg(np.arctan2(sx * s, sy * c)),
        ],
        axis=1,
    )


def detector_postprocess(
    results: Instances, output_height: int, output_width: int,
    mask_threshold: float = 0.5, full_masks: bool = False, paster=None,
) -> Instances:
    """Rescale predictions to the original image resolution.

    Rotated-aware port of reference ``post_processor_academic.py:118-178``
    (scales ``pred_boxes``/``pred_rboxes``, pastes masks via the rotated
    grid, drops empty boxes).  ``paster`` (a ``paste.RotatedMaskPaster``,
    which a runner on a CUDA device holds) computes the mask polygons with
    kernel K3; without one the host loop does, with the same result.
    """
    scale_x = output_width / results.image_size[1]
    scale_y = output_height / results.image_size[0]
    out = Instances((output_height, output_width), **results.get_fields())

    boxes = np.asarray(out.pred_boxes)
    if boxes.shape[-1] == 5:
        boxes = scale_rotated_np(boxes, scale_x, scale_y)
        boxes = _clip_np(boxes, (output_height, output_width))
        nonempty = (boxes[:, 2] > 0) & (boxes[:, 3] > 0)
    else:
        boxes = boxes * np.array([scale_x, scale_y, scale_x, scale_y])
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, output_width)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, output_height)
        nonempty = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    out.pred_boxes = boxes

    if out.has("pred_rboxes"):
        rb = scale_rotated_np(np.asarray(out.pred_rboxes), scale_x, scale_y)
        out.pred_rboxes = _clip_np(rb, (output_height, output_width))

    out = out[nonempty]

    if out.has("pred_masks") and len(out):
        with trace.span("glass.post.polygons"):
            mask_boxes = np.asarray(
                out.pred_rboxes if out.has("pred_rboxes") else out.pred_boxes
            )
            if full_masks:
                from .paste import paste_masks_rotated

                out.pred_masks = paste_masks_rotated(
                    np.asarray(out.pred_masks), mask_boxes,
                    (output_height, output_width), threshold=mask_threshold,
                )
            else:
                # Polygon extraction without the full-resolution paste (the only
                # downstream consumer of pasted masks) — identical contours,
                # computed inside each box's AABB window (paste.py).
                from .paste import rotated_masks_to_polygons

                polygons = paster if paster is not None else rotated_masks_to_polygons
                out.pred_mask_polygons = polygons(
                    np.asarray(out.pred_masks), mask_boxes,
                    (output_height, output_width), threshold=mask_threshold,
                )
                out.remove("pred_masks")
    return out


def build_post_processor(cfg, device=None):
    """``device`` is where the on-device merge (POST_PROCESSING.ON_DEVICE)
    runs: cuda unless the caller asks for the CPU."""
    name = cfg.POST_PROCESSING.NAME
    return {
        "PostProcessorRotatedBoxes": PostProcessorRotatedBoxes,
        "PostProcessorAcademic": PostProcessorAcademic,
    }[name](cfg, device)
