"""Rotated-box geometry in PyTorch (XYWHA_ABS convention).

Counterpart of ``glass_tpu/ops/boxes.py``.  A rotated box is ``(cx, cy, w,
h, angle)`` with ``angle`` in degrees, counter-clockwise in image
coordinates (y pointing down), the detectron2 convention.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

# detectron2 clamps dw/dh deltas to log(1000/16) before exp.
SCALE_CLAMP = math.log(1000.0 / 16.0)


def normalize_angle(angle: torch.Tensor) -> torch.Tensor:
    """Map angles (degrees) into [-180, 180) (floored modulo, as jnp's %)."""
    return torch.remainder(angle + 180.0, 360.0) - 180.0


def boxes_to_polygons(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) XYWHA boxes -> (..., 4, 2) polygons, first vertex top-left."""
    cx, cy, w, h, a = boxes.unbind(-1)
    t = (-a / 180.0) * math.pi
    sin_t, cos_t = torch.sin(t), torch.cos(t)
    xs = torch.stack([
        cx + (h * sin_t - w * cos_t) / 2,
        cx + (h * sin_t + w * cos_t) / 2,
        cx - (h * sin_t - w * cos_t) / 2,
        cx - (h * sin_t + w * cos_t) / 2,
    ], dim=-1)
    ys = torch.stack([
        cy - (h * cos_t + w * sin_t) / 2,
        cy - (h * cos_t - w * sin_t) / 2,
        cy + (h * cos_t + w * sin_t) / 2,
        cy + (h * cos_t - w * sin_t) / 2,
    ], dim=-1)
    return torch.stack([xs, ys], dim=-1)


def clip_rotated_boxes(
    boxes: torch.Tensor, image_size, clip_angle_threshold: float = 1.0
) -> torch.Tensor:
    """detectron2 ``RotatedBoxes.clip``: only nearly axis-aligned boxes
    (|angle| <= threshold) are clipped to the image, others pass through.

    image_size: (h, w) for every box, or a (B, 2) f32 tensor of each image's
    size for (B, N, 5) boxes."""
    if torch.is_tensor(image_size):
        h_img, w_img = image_size[:, 0, None], image_size[:, 1, None]

        def clamp(v, hi):  # clamp(v, 0, hi) with a tensor bound, the same bits
            return torch.minimum(torch.clamp(v, min=0.0), hi)
    else:
        h_img, w_img = float(image_size[0]), float(image_size[1])

        def clamp(v, hi):
            return torch.clamp(v, 0.0, hi)
    cx, cy, w, h, a = boxes.unbind(-1)
    x1 = clamp(cx - w / 2.0, w_img)
    y1 = clamp(cy - h / 2.0, h_img)
    x2 = clamp(cx + w / 2.0, w_img)
    y2 = clamp(cy + h / 2.0, h_img)
    clipped = torch.stack([(x1 + x2) / 2.0, (y1 + y2) / 2.0, x2 - x1, y2 - y1, a], dim=-1)
    nearly_aligned = (torch.abs(a) <= clip_angle_threshold)[..., None]
    return torch.where(nearly_aligned, clipped, boxes)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    return (boxes[..., 2] > threshold) & (boxes[..., 3] > threshold)


def get_deltas(src: torch.Tensor, target: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """Rotated box2box encode (detectron2 ``Box2BoxTransformRotated``)."""
    wx, wy, ww, wh, wa = weights
    sx, sy, sw, sh, sa = src.unbind(-1)
    tx, ty, tw, th, ta = target.unbind(-1)
    dx = wx * (tx - sx) / sw
    dy = wy * (ty - sy) / sh
    dw = ww * torch.log(tw / sw)
    dh = wh * torch.log(th / sh)
    da = normalize_angle(ta - sa) * wa * math.pi / 180.0
    return torch.stack([dx, dy, dw, dh, da], dim=-1)


def apply_deltas(
    deltas: torch.Tensor, boxes: torch.Tensor, weights: Sequence[float]
) -> torch.Tensor:
    """Rotated box2box decode (detectron2 ``Box2BoxTransformRotated``)."""
    wx, wy, ww, wh, wa = weights
    sx, sy, sw, sh, sa = boxes.unbind(-1)
    dx, dy, dw, dh, da = deltas.unbind(-1)
    dw = torch.clamp(dw / ww, max=SCALE_CLAMP)
    dh = torch.clamp(dh / wh, max=SCALE_CLAMP)
    px = dx / wx * sw + sx
    py = dy / wy * sh + sy
    pw = torch.exp(dw) * sw
    ph = torch.exp(dh) * sh
    pa = normalize_angle(da * 180.0 / math.pi / wa + sa)
    return torch.stack([px, py, pw, ph, pa], dim=-1)


def overwrite_orientations_on_boxes(
    boxes: torch.Tensor, orientations: torch.Tensor
) -> torch.Tensor:
    """Snap box angle to the predicted cardinal orientation (reference
    ``glass/utils/rotated_box_utils.py:4-35``)."""
    cx, cy, w, h, a = boxes.unbind(-1)
    box_orient = torch.remainder(torch.round(a / 90.0).to(torch.int32), 4)
    delta = torch.remainder(box_orient - orientations.to(torch.int32), 4)
    swap = (delta == 1) | (delta == 3)
    new_w = torch.where(swap, h, w)
    new_h = torch.where(swap, w, h)
    new_a = normalize_angle(a + 90.0 * delta.to(a.dtype))
    return torch.stack([cx, cy, new_w, new_h, new_a], dim=-1)
