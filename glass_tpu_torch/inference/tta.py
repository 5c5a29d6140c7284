"""Test-time augmentation: ``GlassRunnerWithTTA``.

Counterpart of ``glass_tpu/inference/tta.py`` (the reference's optional
``GeneralizedRCNNWithTTA``, ``TEST.AUG``: horizontal flip and shortest
edges 400-1200, long side at most 4000): detection on every view, each
view's boxes mapped back to the image's frame, all views merged by rotated
NMS at ``ROI_HEADS.NMS_THRESH_TEST`` keeping the top
``TEST.DETECTIONS_PER_IMAGE``, then the recognizer and the mask head once
on the merged boxes at the primary scale (``GlassRunner.
forward_with_given_boxes``).

As in glass_tpu, ``eval_call`` applies the post-processor to the merged
predictions directly: neither the runner's small-box, inflate and overlap
filters nor ``detector_postprocess`` (the mask paste) run on this path.
"""

from __future__ import annotations

import logging
from typing import List

import cv2
import numpy as np

from ..postprocess.np_geometry import nms_rotated_np
from ..postprocess.post_processor import scale_rotated_np
from ..structures import Instances
from ..utils.common import rgb2grey

logger = logging.getLogger(__name__)


class GlassRunnerWithTTA:
    def __init__(self, runner):
        self.runner = runner
        self.aug = runner.cfg.TEST.AUG
        self.nms_thresh = runner.cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST

    def views(self, image: np.ndarray):
        """(view, scale, flipped) for each short side in TEST.AUG.MIN_SIZES
        (the long side capped at TEST.AUG.MAX_SIZE), and its mirror image
        under TEST.AUG.FLIP."""
        h, w = image.shape[:2]
        for short in self.aug.MIN_SIZES:
            scale = short / min(h, w)
            if max(h, w) * scale > self.aug.MAX_SIZE:
                scale = self.aug.MAX_SIZE / max(h, w)
            nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
            resized = cv2.resize(image.astype(np.float32), (nw, nh))
            yield resized, scale, False
            if self.aug.FLIP:
                yield resized[:, ::-1].copy(), scale, True

    @staticmethod
    def boxes_to_image(boxes: np.ndarray, view_width: int, scale: float, flipped: bool) -> np.ndarray:
        """A view's (N, 5) rotated boxes in the image's frame: unflip
        (x -> W - x, angle -> -angle), then scale by 1 / scale."""
        boxes = np.asarray(boxes).copy()
        if flipped:
            boxes[:, 0] = view_width - boxes[:, 0]
            boxes[:, 4] = -boxes[:, 4]
        return scale_rotated_np(boxes, 1.0 / scale, 1.0 / scale)

    def eval_call(self, original_image: np.ndarray) -> Instances:
        """Dataset evaluation (``--tta``): the runner's input-format
        handling, the multi-view merge and heads, then the post-processor."""
        if self.runner.input_format == "RGB":
            original_image = original_image[:, :, ::-1]
        if self.runner.input_format == "GREY":
            original_image = rgb2grey(original_image, three_channels=True)
        preds = self(original_image)
        if self.runner.post_process_flag:
            preds = self.runner.post_processor(preds)
        return preds

    def __call__(self, image: np.ndarray) -> Instances:
        h, w = image.shape[:2]
        all_boxes: List[np.ndarray] = []
        all_scores: List[np.ndarray] = []
        all_orients: List[np.ndarray] = []
        for view, scale, flipped in self.views(image):
            preds = self.runner.run_on_resized(view)
            if len(preds) == 0:
                continue
            all_boxes.append(self.boxes_to_image(preds.pred_boxes, view.shape[1], scale, flipped))
            all_scores.append(np.asarray(preds.scores))
            all_orients.append(np.asarray(preds.orientations))

        if not all_boxes:
            return Instances((h, w), pred_boxes=np.zeros((0, 5), np.float32),
                             scores=np.zeros((0,), np.float32))
        boxes = np.concatenate(all_boxes)
        scores = np.concatenate(all_scores)
        orients = np.concatenate(all_orients)
        keep = nms_rotated_np(boxes, scores, self.nms_thresh)
        topk = keep[: self.runner.cfg.TEST.DETECTIONS_PER_IMAGE]
        merged = Instances((h, w), pred_boxes=boxes[topk], scores=scores[topk],
                           orientations=orients[topk])
        return self.runner.forward_with_given_boxes(image, merged)
