"""Dataset registry and COCO-with-extensions loading.

Re-implements reference ``glass/data/dataset_manager.py``: datasets live at
``<ROOT>/<name>/annotations.json`` in COCO format with the GLASS extra keys
(``text``/``rec``, ``rotated_box`` 4-point quads, ``angle``, ``orientation``,
``word_length`` — see reference ``DATA.md:26-83``).  Parsed with the json
module directly (no pycocotools dependency).  A copy of
``glass_tpu/data/dataset.py``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)

ANN_KEYS = ["iscrowd", "bbox", "category_id", "text", "word_length", "angle",
            "orientation", "id"]

_DATASET_CATALOG: Dict[str, "DatasetInfo"] = {}


class DatasetInfo:
    def __init__(self, name: str, root: str):
        self.name = name
        self.root = root
        self.json_file = os.path.join(root, name.replace("_coco", ""), "annotations.json")
        if not os.path.exists(self.json_file):
            self.json_file = os.path.join(root, name, "annotations.json")
        self.image_root = os.path.dirname(self.json_file)

    def load(self) -> List[dict]:
        return load_coco_json(self.json_file, self.image_root, self.name)


def rotated_box_anno_to_xywha(rotated_box) -> List[float]:
    """4x2 vertices (top-left first, clockwise) -> XYWHA.

    Matches reference ``dataset_manager.rotated_box_anno_to_xywha:209-218``.
    """
    box = np.asarray(rotated_box, np.float64).reshape(4, 2)
    center_x, center_y = box.mean(axis=0)
    width = float(np.linalg.norm(box[1] - box[0]))
    height = float(np.linalg.norm(box[2] - box[1]))
    angle = float(np.rad2deg(np.arctan2(box[0, 1] - box[1, 1], box[1, 0] - box[0, 0])))
    return [float(center_x), float(center_y), width, height, angle]


def xywh_to_xywha(bbox) -> List[float]:
    x, y, w, h = bbox
    return [x + w / 2.0, y + h / 2.0, w, h, 0.0]


def load_coco_json(json_file: str, image_root: str, dataset_name: str) -> List[dict]:
    with open(json_file, "r") as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}

    anns_by_image: Dict[int, List[dict]] = {}
    for ann in coco.get("annotations", []):
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img in coco.get("images", []):
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "dataset_name": dataset_name.replace("_coco", ""),
            "height": img.get("height"),
            "width": img.get("width"),
            "image_id": img["id"],
        }
        objs = []
        for ann in anns_by_image.get(img["id"], []):
            if ann.get("iscrowd", 0):
                continue
            obj = {k: ann[k] for k in ANN_KEYS if k in ann}
            segm = ann.get("segmentation")
            if segm and not isinstance(segm, dict):
                segm = [p for p in segm if len(p) % 2 == 0 and len(p) >= 6]
                obj["segmentation"] = segm
            text = ann.get("rec", "")
            if text:
                obj["text"] = text
            if ann.get("rotated_box"):
                obj["bbox"] = rotated_box_anno_to_xywha(ann["rotated_box"])
            else:
                obj["bbox"] = xywh_to_xywha(ann["bbox"])
            obj["angle"] = ann.get("angle")
            obj["orientation"] = ann.get("orientation")
            if id_map:
                obj["category_id"] = id_map.get(obj.get("category_id", 1), 0)
            unique = f"{dataset_name}_{obj.get('id')}"
            obj["id"] = int(hashlib.md5(unique.encode()).hexdigest()[:10], 16)
            objs.append(obj)
        record["annotations"] = objs
        records.append(record)
    logger.info("Loaded %d images from %s", len(records), json_file)
    return records


class DatasetManager:
    """Registers the datasets named in cfg.DATASETS into the catalog."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.root = cfg.DATASETS.ROOT

    def register(self):
        for name in list(self.cfg.DATASETS.TRAIN) + list(self.cfg.DATASETS.TEST):
            prev = _DATASET_CATALOG.get(name)
            if prev is not None and prev.root != self.root:
                # Same name, different DATASETS.ROOT: the old entry would
                # silently shadow the new location for the rest of the
                # process (d2 raises on duplicate register; our register is
                # implicit-from-config, so overwrite-and-warn is the sane
                # semantic).
                logger.warning(
                    "dataset %r re-registered with a new root: %s -> %s",
                    name, prev.root, self.root,
                )
            if prev is None or prev.root != self.root:
                _DATASET_CATALOG[name] = DatasetInfo(name, self.root)

    @staticmethod
    def get(name: str) -> DatasetInfo:
        return _DATASET_CATALOG[name]

    @staticmethod
    def load(name: str) -> List[dict]:
        return _DATASET_CATALOG[name].load()
