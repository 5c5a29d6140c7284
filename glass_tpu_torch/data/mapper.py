"""Per-sample train/test mapping: read, augment, build padded targets.

A copy of glass_tpu's ``data/mapper.py`` (host code, no JAX).

Re-implements reference ``glass/data/dataset_mapper.py`` plus the transform
behaviours it inherits/patches:

* cardinal ``RandomRotation`` choice (weighted list, expand=True),
* ``ResizeShortestEdge`` with "range" sampling (nearest-neighbour at train —
  the reference's FastResizeTransform patch, ``transforms/transform.py:8-17``),
* horizontal ``RandomFlip``,
* rotated-box transform handling (center via coords, angle adjusted; the
  ``"rotated_box"`` handler the reference registers at import),
* orientation recomputed after rotation (``dataset_mapper.py:236-243``).

Output is a dict of fixed-shape numpy arrays ready for the padded batcher.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import cv2
import numpy as np

from ..text import TextCodec
from ..utils.common import rgb2grey

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# transforms (numpy affine pipeline)
# ---------------------------------------------------------------------------


class AffineAug:
    """Composable 2x3 affine + flags the rotated-box update needs."""

    def __init__(self, matrix: np.ndarray, out_size: Tuple[int, int],
                 added_angle: float = 0.0, flipped: bool = False,
                 scale: Tuple[float, float] = (1.0, 1.0)):
        self.matrix = matrix  # maps input (x, y, 1) -> output (x, y)
        self.out_size = out_size  # (h, w)
        self.added_angle = added_angle
        self.flipped = flipped
        self.scale = scale

    def apply_coords(self, pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, np.float64)
        return pts @ self.matrix[:, :2].T + self.matrix[:, 2]


def rotation_aug(h: int, w: int, angle: float) -> AffineAug:
    """d2 RotationTransform with expand=True."""
    center = ((w - 1) / 2.0, (h - 1) / 2.0)
    rad = np.deg2rad(angle)
    abs_cos, abs_sin = abs(np.cos(rad)), abs(np.sin(rad))
    bound_w = int(np.rint(h * abs_sin + w * abs_cos))
    bound_h = int(np.rint(h * abs_cos + w * abs_sin))
    # expand: shift so the rotated image fits the new bound
    rm_image = cv2.getRotationMatrix2D(center, angle, 1.0)
    rm_image[0, 2] += (bound_w - 1) / 2.0 - center[0]
    rm_image[1, 2] += (bound_h - 1) / 2.0 - center[1]
    return AffineAug(rm_image, (bound_h, bound_w), added_angle=angle)


def resize_aug(h: int, w: int, new_h: int, new_w: int) -> AffineAug:
    sx, sy = new_w / w, new_h / h
    m = np.array([[sx, 0, 0], [0, sy, 0]], np.float64)
    return AffineAug(m, (new_h, new_w), scale=(sx, sy))


def hflip_aug(h: int, w: int) -> AffineAug:
    m = np.array([[-1, 0, w], [0, 1, 0]], np.float64)
    return AffineAug(m, (h, w), flipped=True)


def crop_aug(y0: int, x0: int, ch: int, cw: int) -> AffineAug:
    m = np.array([[1, 0, -x0], [0, 1, -y0]], np.float64)
    return AffineAug(m, (ch, cw))


def apply_aug_image(aug: AffineAug, image: np.ndarray, nearest: bool) -> np.ndarray:
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.warpAffine(
        image, aug.matrix[:2], (aug.out_size[1], aug.out_size[0]), flags=interp
    )


def apply_aug_rotated_boxes(aug: AffineAug, boxes: np.ndarray) -> np.ndarray:
    """Update XYWHA boxes under the affine (d2 transform conventions)."""
    if len(boxes) == 0:
        return boxes
    out = boxes.astype(np.float64).copy()
    out[:, :2] = aug.apply_coords(out[:, :2])
    if aug.scale != (1.0, 1.0):
        sx, sy = aug.scale
        theta = np.deg2rad(out[:, 4])
        c, s = np.cos(theta), np.sin(theta)
        out[:, 2] *= np.sqrt((sx * c) ** 2 + (sy * s) ** 2)
        out[:, 3] *= np.sqrt((sx * s) ** 2 + (sy * c) ** 2)
        out[:, 4] = np.rad2deg(np.arctan2(sx * s, sy * c))
    if aug.added_angle:
        out[:, 4] += aug.added_angle
    if aug.flipped:
        out[:, 4] = -out[:, 4]
    return out.astype(np.float32)


def shortest_edge_size(h, w, short, max_size):
    scale = short / min(h, w)
    if h < w:
        new_h, new_w = short, scale * w
    else:
        new_h, new_w = scale * h, short
    if max(new_h, new_w) > max_size:
        scale2 = max_size / max(new_h, new_w)
        new_h, new_w = new_h * scale2, new_w * scale2
    return int(new_h + 0.5), int(new_w + 0.5)


# ---------------------------------------------------------------------------
# mapper
# ---------------------------------------------------------------------------


class DatasetMapper:
    def __init__(self, cfg, is_train: bool = True, rng: Optional[np.random.RandomState] = None):
        self.is_train = is_train
        self.rng = rng or np.random.RandomState()
        self.img_format = cfg.INPUT.FORMAT
        self.mask_on = cfg.MODEL.MASK_ON
        self.rotation_enabled = cfg.INPUT.ROTATION.ENABLED and is_train
        self.rotation_angles = list(cfg.INPUT.ROTATION.ANGLES)
        self.min_size_train = cfg.INPUT.MIN_SIZE_TRAIN
        self.min_size_sampling = cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING
        self.max_size_train = cfg.INPUT.MAX_SIZE_TRAIN
        self.min_size_test = cfg.INPUT.MIN_SIZE_TEST
        self.max_size_test = cfg.INPUT.MAX_SIZE_TEST
        self.flip = cfg.INPUT.RANDOM_FLIP != "none" and is_train
        self.crop_prob = cfg.DATASETS.RANDOM_CROP_PROB if is_train else 0.0
        self.crop_rel = 0.7
        self.codec = TextCodec.from_config(cfg)

    def _read_image(self, record) -> np.ndarray:
        img = cv2.imread(record["file_name"], cv2.IMREAD_COLOR)  # BGR
        if img is None:
            raise FileNotFoundError(record["file_name"])
        if self.img_format == "RGB":
            img = img[:, :, ::-1]
        elif self.img_format == "GREY":
            img = rgb2grey(img[:, :, ::-1], three_channels=True)
        return img

    def _instance_crop_origin(self, h, w, ch, cw, annos) -> Tuple[int, int]:
        """Crop origin containing a random gt instance's center.

        Reference semantics (``dataset_mapper.py:89-100`` +
        d2 ``gen_crop_transform_with_instance``): pick one annotation at
        random and constrain the window so the instance center lies inside
        it; uniform crop only when the image has no instances.
        """
        if not annos:
            return (
                self.rng.randint(0, h - ch + 1),
                self.rng.randint(0, w - cw + 1),
            )
        anno = annos[self.rng.randint(len(annos))]
        bbox = np.asarray(anno["bbox"], np.float64)
        cy, cx = float(bbox[1]), float(bbox[0])  # XYWHA center
        cy, cx = min(max(cy, 0.0), h - 1.0), min(max(cx, 0.0), w - 1.0)
        min_y = max(int(np.floor(cy)) - ch, 0)
        min_x = max(int(np.floor(cx)) - cw, 0)
        max_y = min(max(h - ch, 0), int(np.ceil(cy)))
        max_x = min(max(w - cw, 0), int(np.ceil(cx)))
        y0 = self.rng.randint(min_y, max_y + 1) if max_y >= min_y else min_y
        x0 = self.rng.randint(min_x, max_x + 1) if max_x >= min_x else min_x
        return y0, x0

    def _build_augs(self, h, w, annos=None) -> List[AffineAug]:
        augs = []
        if self.is_train:
            if self.crop_prob > 0 and self.rng.rand() < self.crop_prob:
                c = self.crop_rel + self.rng.rand() * (1 - self.crop_rel)
                ch, cw = int(h * c + 0.5), int(w * c + 0.5)
                y0, x0 = self._instance_crop_origin(h, w, ch, cw, annos or [])
                augs.append(crop_aug(y0, x0, ch, cw))
                h, w = ch, cw
            if self.rotation_enabled:
                angle = float(self.rng.choice(self.rotation_angles))
                if angle != 0.0:
                    aug = rotation_aug(h, w, angle)
                    augs.append(aug)
                    h, w = aug.out_size
            if self.min_size_sampling == "range":
                lo, hi = self.min_size_train
                short = self.rng.randint(int(lo), int(hi) + 1)
            else:
                short = int(self.rng.choice(list(self.min_size_train)))
            nh, nw = shortest_edge_size(h, w, short, self.max_size_train)
            augs.append(resize_aug(h, w, nh, nw))
            h, w = nh, nw
            if self.flip and self.rng.rand() < 0.5:
                augs.append(hflip_aug(h, w))
        else:
            nh, nw = shortest_edge_size(h, w, self.min_size_test, self.max_size_test)
            augs.append(resize_aug(h, w, nh, nw))
        return augs

    def __call__(self, record: dict) -> dict:
        image = self._read_image(record)
        h, w = image.shape[:2]
        augs = self._build_augs(h, w, record.get("annotations"))

        for i, aug in enumerate(augs):
            nearest = self.is_train and isinstance(aug, AffineAug) and aug.scale != (1, 1)
            image = apply_aug_image(aug, image, nearest=nearest)

        out = {
            "image": np.ascontiguousarray(image.astype(np.float32)),
            "height": record.get("height", h),
            "width": record.get("width", w),
            "image_id": record.get("image_id", 0),
            "file_name": record.get("file_name", ""),
            "dataset_name": record.get("dataset_name", ""),
        }
        if not self.is_train or "annotations" not in record:
            return out

        annos = record["annotations"]
        boxes = np.array([a["bbox"] for a in annos], np.float32).reshape(-1, 5)
        texts = [a.get("text", "") for a in annos]
        classes = np.array([a.get("category_id", 0) for a in annos], np.int64)
        angles = np.array(
            [a.get("angle") if a.get("angle") is not None else 0.0 for a in annos],
            np.float32,
        )
        polys = []
        for a in annos:
            segm = a.get("segmentation") or []
            if segm:
                pts = np.asarray(segm[0], np.float64).reshape(-1, 2)
            else:
                pts = np.zeros((0, 2))
            polys.append(pts)

        added_angle = 0.0
        for aug in augs:
            boxes = apply_aug_rotated_boxes(aug, boxes)
            polys = [
                aug.apply_coords(p) if len(p) else p for p in polys
            ]
            if isinstance(aug, AffineAug) and aug.flipped:
                polys = [p[::-1] if len(p) else p for p in polys]
            added_angle += aug.added_angle

        # Orientation after rotation aug (reference dataset_mapper.py:236-243).
        total_angles = angles + added_angle
        orientation = ((90 * np.round(total_angles / 90)) % 360).astype(np.float32)
        orientation_cls = (np.round(orientation / 90) % 4).astype(np.int64)

        # Empty-instance filter (utils.filter_empty_instances on rboxes).
        nonempty = (boxes[:, 2] > 0) & (boxes[:, 3] > 0)
        keep = np.where(nonempty)[0]

        out.update(
            gt_boxes=boxes[keep],
            gt_classes=classes[keep],
            gt_orientation=orientation_cls[keep],
            gt_text=self.codec.encode([texts[i] for i in keep]),
            gt_polygons=[polys[i] for i in keep],
        )
        return out
