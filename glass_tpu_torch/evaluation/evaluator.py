"""Dataset evaluator: predictions -> RRC protocol metrics.

The reference ``TextEvaluator`` (``glass/evaluation/text_evaluator.py``)
serializes predictions to per-image txt files, zips them and invokes the
official script against **hardcoded internal gt zip paths**
(``text_evaluator.py:57-74``).  Here gt can come from either source, both
parameterized:

* the registered COCO dataset itself (polygon/rotated-box annotations +
  transcriptions) — the default, no extra files needed,
* an RRC-format gt zip (``x1,y1,...,x4,y4,[####]transcription`` lines) via
  ``DATASETS.EVAL_GT_ZIPS`` for byte-exact protocol compatibility.

Prediction conversion mirrors ``instances_to_coco_json``: with masks, the
largest mask contour becomes the polygon; otherwise the rotated box's 4
vertices.  Optional lexicon correction matches ``lexicon_utils``.

A copy of ``glass_tpu/evaluation/evaluator.py``; the gather across
processes runs over ``torch.distributed``.
"""

from __future__ import annotations

import io
import logging
import os
import re
import zipfile
from typing import Dict, List, Optional

import cv2
import numpy as np

from ..postprocess.np_geometry import boxes_to_polygons_np
from ..structures import Instances
from ..text import TextCodec, decode_instance_texts
from .text_eval import EvalInstance, evaluate_dataset
from .lexicon import Lexicon, LexiconSet, match_transcript

logger = logging.getLogger(__name__)


def mask_to_polygon(mask: np.ndarray) -> Optional[np.ndarray]:
    """Largest external contour of a binary mask (reference masks_to_polygons)."""
    contours, _ = cv2.findContours(
        mask.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    if not contours:
        return None
    largest = max(contours, key=cv2.contourArea)
    poly = largest.reshape(-1, 2).astype(np.float64)
    if len(poly) < 3:
        return None
    return poly


def strip_special_chars(text: str) -> str:
    """Leading/trailing special-char strip (reference instances_to_coco_json)."""
    return text.strip("'!?.:,*\"()·[]/")


def instances_to_eval(
    preds: Instances,
    codec: TextCodec,
    use_masks: bool = True,
    lexicon: Optional[Lexicon] = None,
    lexicon_set: Optional[LexiconSet] = None,
    image_id: Optional[str] = None,
    word_spotting: bool = False,
) -> List[EvalInstance]:
    out: List[EvalInstance] = []
    if len(preds) == 0:
        return out
    prob_matrix = (
        np.asarray(preds.pred_text_prob) if preds.has("pred_text_prob") else None
    )
    weighted = bool(
        (lexicon_set is not None and lexicon_set.weighted)
        or (lexicon is not None and getattr(lexicon, "weighted", False))
    )
    if weighted and prob_matrix is None:
        raise ValueError(
            "Weighted-edit-distance lexicon correction needs the full "
            "per-step character distributions; run the model with "
            "TPU.TEXT_EMIT=probs (tools/eval_glass.py sets this "
            "automatically for --weighted-ed)."
        )
    texts, scores, char_scores = decode_instance_texts(preds, codec)
    boxes = np.asarray(preds.pred_boxes)
    det_scores = np.asarray(preds.scores)
    has_mask_polys = use_masks and preds.has("pred_mask_polygons")
    has_masks = use_masks and preds.has("pred_masks")
    box_polys = boxes_to_polygons_np(boxes) if boxes.shape[-1] == 5 else None

    for i in range(len(preds)):
        poly = None
        if has_mask_polys:
            poly = preds.pred_mask_polygons[i]
        elif has_masks:
            poly = mask_to_polygon(np.asarray(preds.pred_masks[i]))
        if poly is None and box_polys is not None:
            poly = box_polys[i]
        if poly is None:
            continue
        text = strip_special_chars(texts[i])
        if lexicon_set is not None:
            # Full benchmark protocol (text_evaluator.py:183-201): replace
            # within EDIT_DISTANCE_THR (always for the generic type), DROP
            # otherwise.  Char probs skip the leading [GO] step so position
            # j aligns with text[j] (decode starts emitting at step 0).
            corrected = lexicon_set.correct(
                text, image_id=image_id,
                char_probs=prob_matrix[i] if prob_matrix is not None else None,
                char_encode=codec.char_encode,
            )
            if corrected is None:
                continue
            text = corrected
        elif lexicon is not None and text:
            text = lexicon.correct(
                text, prob_matrix[i] if prob_matrix is not None else None, codec
            )
        if lexicon_set is not None or lexicon is not None or word_spotting:
            text = match_transcript(text, word_spotting)
        out.append(
            EvalInstance(
                points=poly, transcription=text, confidence=float(det_scores[i])
            )
        )
    return out


# ---------------------------------------------------------------------------
# RRC zip gt parsing (compatibility path)
# ---------------------------------------------------------------------------


def load_gt_zip(
    path: str,
    sample_pattern: str = r"([0-9]+)",
    strict: Optional[bool] = None,
    line_format: Optional[str] = None,
) -> Dict[str, List[EvalInstance]]:
    """Parse an RRC-format gt zip into per-image EvalInstances.

    ``strict`` (the default for external zips) rejects malformed lines with
    the official harness's per-line errors — reference
    ``rrc_evaluation_funcs.py:96-140`` ``validate_lines_in_file_gt`` via
    ``text_eval_script.py:40-62`` ``validate_data``. ``strict=False`` keeps
    the lenient best-effort parse for ad-hoc zips.
    """
    from .rrc_validation import (
        get_tl_line_values_gt,
        line_format_for,
        validate_lines_in_file_gt,
    )

    if strict is None:
        strict = True
    if line_format is None:
        line_format = line_format_for(path)
    out: Dict[str, List[EvalInstance]] = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            m = re.search(sample_pattern, os.path.basename(name))
            if not m:
                continue
            key = m.group(1)
            raw = zf.read(name)
            if strict:
                validate_lines_in_file_gt(name, raw, line_format)
            lines = raw.decode("utf-8-sig").replace("\r", "").split("\n")
            insts = []
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                if strict:
                    pts, _, trans = get_tl_line_values_gt(line, line_format)
                    coords = np.asarray(pts, np.float64)
                else:
                    if "####" in line:
                        coords_part, trans = line.split("####", 1)
                        parts = [p for p in coords_part.strip().rstrip(",").split(",") if p]
                    else:
                        parts = line.split(",")
                        trans = parts[-1]
                        parts = parts[:-1]
                    try:
                        coords = np.array([float(p) for p in parts], np.float64)
                    except ValueError:
                        coords = np.array(
                            [float(p) for p in parts[:-1]], np.float64
                        )
                        trans = parts[-1] + "," + trans
                    if len(coords) < 6:
                        continue
                insts.append(
                    EvalInstance(points=coords.reshape(-1, 2), transcription=trans)
                )
            out[key] = insts
    return out


class TextEvaluator:
    """Accumulates per-image predictions, computes E2E + det-only metrics."""

    def __init__(
        self,
        dataset_name: str,
        cfg,
        output_dir: Optional[str] = None,
        gt_zip: Optional[str] = None,
        word_spotting: Optional[bool] = None,
        lexicon: Optional[Lexicon] = None,
        lexicon_set: Optional[LexiconSet] = None,
    ):
        self.dataset_name = dataset_name
        self.cfg = cfg
        self.codec = TextCodec.from_config(cfg)
        self.output_dir = output_dir
        if word_spotting is None:
            word_spotting = bool(getattr(cfg, "IS_WORD_SPOTTING", False))
        self.word_spotting = word_spotting
        self.lexicon = lexicon
        # Config-driven protocol lexicons (TEST.LEXICON_TYPE) unless an
        # explicit LexiconSet (or legacy single-file Lexicon) is given.
        if lexicon_set is None and lexicon is None:
            lexicon_set = LexiconSet.from_config(cfg)
        self.lexicon_set = lexicon_set
        self.use_masks = cfg.MODEL.MASK_ON and cfg.MODEL.ROI_MASK_HEAD.MASK_INFERENCE
        self._dets: Dict[str, List[EvalInstance]] = {}
        self._gts: Dict[str, List[EvalInstance]] = {}
        if gt_zip:
            pattern = r"gt_img_([0-9]+)" if "icdar" in dataset_name.lower() else r"([0-9]+)"
            from .rrc_validation import line_format_for

            # dialect from the dataset name OR the zip path, whichever
            # names totaltext/textocr (reference text_eval_script.py:46
            # keys off the gt path alone)
            fmt = line_format_for(dataset_name + " " + gt_zip)
            self._gt_from_zip = load_gt_zip(gt_zip, pattern, line_format=fmt)
        else:
            self._gt_from_zip = None

    def process(self, image_key: str, preds: Instances, gt_record: Optional[dict] = None):
        self._dets[image_key] = instances_to_eval(
            preds, self.codec, self.use_masks, self.lexicon,
            lexicon_set=self.lexicon_set, image_id=image_key,
            word_spotting=self.word_spotting,
        )
        if self._gt_from_zip is None and gt_record is not None:
            gts = []
            for ann in gt_record.get("annotations", []):
                segm = ann.get("segmentation")
                if segm:
                    pts = np.asarray(segm[0], np.float64).reshape(-1, 2)
                else:
                    pts = boxes_to_polygons_np(
                        np.asarray(ann["bbox"], np.float32).reshape(1, 5)
                    )[0]
                text = ann.get("text", "") or "###"
                gts.append(EvalInstance(points=pts, transcription=text))
            self._gts[image_key] = gts

    def gather_across_processes(self):
        """Merge per-process results in a multi-process evaluation.

        The reference gathers predictions to rank 0 over NCCL/gloo
        (``text_evaluator.py:246-252``); here every process allgathers the
        (dets, gts) dicts (``all_gather_object``), so each computes the
        metrics of the whole set (callers shard the records with
        ``records[rank::world]``).  The dicts merge in rank order.  A no-op
        in a single process.
        """
        import torch.distributed as dist

        from ..parallel import mesh

        if mesh.world_size() == 1:
            return
        shards = [None] * mesh.world_size()
        dist.all_gather_object(shards, (self._dets, self._gts))
        dets, gts = {}, {}
        for d, g in shards:
            dets.update(d)
            gts.update(g)
        self._dets, self._gts = dets, gts

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        self.gather_across_processes()
        gts = self._gt_from_zip if self._gt_from_zip is not None else self._gts
        if self._gt_from_zip is not None:
            # Only evaluate keys present in gt (official behaviour).
            dets = {k: self._dets.get(k, []) for k in gts}
        else:
            dets = self._dets
        per_sample: Dict[str, Dict] = {}
        results = evaluate_dataset(
            gts,
            dets,
            self.word_spotting,
            per_sample=per_sample,
            confidences=bool(getattr(self.cfg.TEST, "CONFIDENCES", False)),
        )
        logger.info("%s: %s", self.dataset_name, results)
        from ..parallel import mesh

        if self.output_dir and mesh.rank() == 0:  # every rank holds the same merged set
            self._write_outputs(per_sample)
        return results

    def _write_outputs(self, per_sample: Optional[Dict[str, Dict]] = None):
        os.makedirs(self.output_dir, exist_ok=True)
        if per_sample is not None:
            import json

            ppath = os.path.join(
                self.output_dir, f"{self.dataset_name}_per_sample.json"
            )
            with open(ppath, "w") as f:
                json.dump(per_sample, f, indent=1, sort_keys=True)
            logger.info("Wrote per-sample metrics to %s", ppath)
        zpath = os.path.join(self.output_dir, f"{self.dataset_name}_det.zip")
        with zipfile.ZipFile(zpath, "w") as zf:
            for key, dets in self._dets.items():
                buf = io.StringIO()
                for d in dets:
                    coords = ",".join(
                        str(int(round(v))) for v in np.asarray(d.points).ravel()
                    )
                    buf.write(f"{coords},####{d.transcription}\n")
                zf.writestr(f"res_img_{key}.txt", buf.getvalue())
        logger.info("Wrote detections to %s", zpath)
