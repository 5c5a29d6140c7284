"""The plain reference of the served path: a frozen copy of the resize,
padding, one-image model program and host post-processing that
``GlassRunner.eval_batch_call`` (per image) and ``GlassRunner.__call__`` run,
on the copy of the model in ``reference/glass`` at float32 (TF32 off).

It imports nothing of the program.  ``glass_inference_single`` is looked up
on this module, so the benchmark's capture can wrap it here as it does in
the program's runner (the control takes the program's place that way).
"""

from __future__ import annotations

import cv2
import numpy as np
import torch

from .config import Node
from .glass.models.glass_rcnn import GlassArch, GlassRCNN, glass_inference_single  # noqa: F401
from .glass.postprocess.post_processor import (
    build_post_processor,
    detector_postprocess,
    scale_rotated_np,
)
from .glass.structures import Instances


def no_tf32() -> None:
    """The reference's float32 is float32: no TF32 in products or
    convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def shortest_edge_size(h, w, short, max_size):
    """d2 ``ResizeShortestEdge`` target size."""
    scale = short / min(h, w)
    if h < w:
        new_h, new_w = short, scale * w
    else:
        new_h, new_w = scale * h, short
    if max(new_h, new_w) > max_size:
        scale2 = max_size / max(new_h, new_w)
        new_h, new_w = new_h * scale2, new_w * scale2
    return int(new_h + 0.5), int(new_w + 0.5)


def f32_cfg(cfg: Node) -> Node:
    """The configuration with the model computed in float32."""
    out = Node(cfg)
    out.TPU = Node(cfg.TPU)
    out.TPU.COMPUTE_DTYPE = "float32"
    return out


def build_model(cfg: Node, state_dict: dict, device) -> GlassRCNN:
    """The reference model of ``cfg`` at float32 with ``state_dict`` (d2
    names) loaded."""
    model = GlassRCNN(GlassArch.from_config(f32_cfg(cfg)))
    model.load_state_dict(state_dict)
    return model.to(device)


def _set_text_fields(inst: Instances, out: dict, sel) -> None:
    if "text_probs" in out:
        inst.pred_text_prob = out["text_probs"][sel]
    if "text_ids" in out:
        inst.pred_text_ids = out["text_ids"][sel]
        inst.pred_text_step_scores = out["text_step_scores"][sel]


def _unpack_masks(m: np.ndarray) -> np.ndarray:
    return m.astype(np.float32) / 255.0 if m.dtype == np.uint8 else m


class RefRunner:
    """One image at a time through the served path of ``cfg``."""

    def __init__(self, cfg: Node, model: GlassRCNN, device):
        self.cfg, self.model, self.device = cfg, model.eval(), torch.device(device)
        self.post_processor = build_post_processor(cfg)
        self.buckets = [tuple(b) for b in cfg.TPU.IMAGE_BUCKETS]
        self.pad_multiple = cfg.TPU.PAD_IMAGE_TO_MULTIPLE

    # -- geometry ---------------------------------------------------------
    def pick_bucket(self, h: int, w: int):
        ph, pw = round_up(h, self.pad_multiple), round_up(w, self.pad_multiple)
        fits = [b for b in self.buckets if b[0] >= ph and b[1] >= pw]
        return min(fits, key=lambda b: b[0] * b[1]) if fits else (ph, pw)

    def scale_ratio(self, shape) -> float:
        cfg = self.cfg.INPUT
        max_dim = max(shape[:2])
        if max_dim > cfg.MAX_SIZE_TEST:
            return cfg.MAX_SIZE_TEST / max_dim
        if max_dim < cfg.MIN_SIZE_TEST:
            return min(cfg.MAX_UPSCALE_RATIO, cfg.MIN_SIZE_TEST / max_dim)
        return 1.0

    def to_bgr(self, image: np.ndarray) -> np.ndarray:
        fmt = self.cfg.INPUT.FORMAT
        if fmt == "RGB":
            return image[:, :, ::-1]
        if fmt == "GREY":
            grey = image[..., 0] * 0.299 + image[..., 1] * 0.587 + image[..., 2] * 0.114
            return np.repeat(grey[..., None], 3, axis=2).astype(image.dtype)
        return image

    def eval_resize(self, image: np.ndarray):
        """``eval_batch_call``'s resize: (resized, (oh, ow))."""
        img = self.to_bgr(image)
        oh, ow = img.shape[:2]
        nh, nw = shortest_edge_size(oh, ow, self.cfg.INPUT.MIN_SIZE_TEST, self.cfg.INPUT.MAX_SIZE_TEST)
        if not (self.cfg.TPU.EVAL_UINT8_TRANSFER and img.dtype == np.uint8):
            img = img.astype(np.float32)
        return cv2.resize(img, (nw, nh)), (oh, ow)

    def serve_resize(self, image: np.ndarray):
        """``__call__``'s resize: (resized float32, scale ratio)."""
        img = self.to_bgr(image)
        ratio = self.scale_ratio(img.shape)
        if ratio != 1:
            nh, nw = int(np.round(ratio * img.shape[0])), int(np.round(ratio * img.shape[1]))
            return cv2.resize(img.astype(np.float32), (nw, nh), interpolation=cv2.INTER_LINEAR), ratio
        return img.astype(np.float32), ratio

    def padded(self, resized: np.ndarray) -> torch.Tensor:
        h, w = resized.shape[:2]
        bh, bw = self.pick_bucket(h, w)
        pad = np.zeros((bh, bw, 3), np.uint8 if resized.dtype == np.uint8 else np.float32)
        pad[:h, :w] = resized
        return torch.from_numpy(pad).to(self.device)

    # -- model ------------------------------------------------------------
    def run_model(self, resized: np.ndarray) -> dict:
        """The fixed-capacity fields of one resized image, as numpy."""
        h, w = resized.shape[:2]
        with torch.no_grad():
            out = glass_inference_single_here(self.model, self.padded(resized), (h, w))
        return {k: v.cpu().numpy() for k, v in out.items()}

    # -- host -------------------------------------------------------------
    def raw_instances(self, out: dict, hw) -> Instances:
        """The valid rows of the fixed-capacity fields (``collect_batch``)."""
        valid = out["valid"]
        inst = Instances(tuple(int(v) for v in hw), pred_boxes=out["boxes"][valid],
                         scores=out["scores"][valid], pred_classes=out["classes"][valid],
                         orientations=out["orientations"][valid])
        _set_text_fields(inst, out, valid)
        if "mask_probs" in out:
            inst.pred_masks = _unpack_masks(out["mask_probs"][valid])
            inst.pred_rboxes = out["boxes"][valid]
        return inst

    def model_postprocess(self, preds: Instances, height: int, width: int) -> Instances:
        pp, proc = self.cfg.POST_PROCESSING, self.post_processor
        if pp.MIN_BOX_DIMENSION:
            preds = proc.filter_small_boxes(preds)
        if pp.INFLATE_RATIO:
            preds = proc.resize_boxes(preds, pp.INFLATE_RATIO)
        if pp.DROP_OVERLAPPING:
            preds = proc.drop_overlapping_boxes(preds, pp.IOA_THRESHOLD, self.cfg.INFERENCE_TH_TEST)
        return detector_postprocess(preds, height, width)

    def eval_post(self, out: dict, hw, orig_hw) -> Instances:
        """``eval_batch_call``'s host stage for one image."""
        preds = self.model_postprocess(self.raw_instances(out, hw), *orig_hw)
        return self.post_processor(preds)

    def serve_post(self, out: dict, hw, ratio: float, orig_hw) -> Instances:
        """``__call__``'s host stage."""
        preds = self.model_postprocess(self.raw_instances(out, hw), *hw)
        if ratio != 1 and len(preds):
            preds.pred_boxes = scale_rotated_np(np.asarray(preds.pred_boxes), 1.0 / ratio, 1.0 / ratio)
        preds._image_size = tuple(orig_hw)
        return self.post_processor(preds)

    def eval_image(self, image: np.ndarray) -> Instances:
        resized, orig_hw = self.eval_resize(image)
        return self.eval_post(self.run_model(resized), resized.shape[:2], orig_hw)

    def serve_image(self, image: np.ndarray) -> Instances:
        resized, ratio = self.serve_resize(image)
        return self.serve_post(self.run_model(resized), resized.shape[:2], ratio, image.shape[:2])


def glass_inference_single_here(model, image, hw):
    """The module-level name the runner calls (and a capture may wrap)."""
    return glass_inference_single(model, image, hw)

