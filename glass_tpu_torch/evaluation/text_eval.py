"""ICDAR/RRC end-to-end text spotting evaluation protocol.

Clean-room implementation of the official matching rules used by the
reference (``glass/evaluation/text_eval_script.py``):

* greedy 1:1 matching on polygon IoU > 0.5,
* gt entries transcribed ``###`` are don't-care; detections covered > 0.5
  (intersection / det area) by a don't-care gt are excluded,
* E2E correctness: case-insensitive transcription equality with special
  characters allowed at the gt word's first/last position (or, for word
  spotting, zero edit distance after dictionary filtering with min length 3),
* detection-only results use only the ``###`` don't-cares,
* global P/R/hmean accumulated over all images.

Operates on in-memory per-image records — no zip/txt round-trip required —
with zip-compatible entry points in evaluator.py.  A copy of
``glass_tpu/evaluation/text_eval.py``; the edit distance is the port's own
(``lexicon.edit_distance``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .lexicon import edit_distance
from .polygon import (
    polygon_area,
    polygon_intersection_area,
    pairwise_polygon_iou,
)

SPECIAL_CHARACTERS = "!?.:,*\"()·[]/'"
MIN_LENGTH_CARE_WORD = 3
IOU_CONSTRAINT = 0.5
AREA_PRECISION_CONSTRAINT = 0.5


@dataclass
class EvalInstance:
    points: np.ndarray  # (N, 2)
    transcription: str
    confidence: float = 1.0


def transcription_match(
    trans_gt: str,
    trans_det: str,
    special_characters: str = SPECIAL_CHARACTERS,
    only_remove_first_last_character_gt: bool = True,
) -> bool:
    if only_remove_first_last_character_gt:
        if trans_gt == trans_det:
            return True
        if trans_gt and special_characters.find(trans_gt[0]) > -1:
            if trans_gt[1:] == trans_det:
                return True
        if trans_gt and special_characters.find(trans_gt[-1]) > -1:
            if trans_gt[:-1] == trans_det:
                return True
        if (
            len(trans_gt) >= 2
            and special_characters.find(trans_gt[0]) > -1
            and special_characters.find(trans_gt[-1]) > -1
        ):
            if trans_gt[1:-1] == trans_det:
                return True
        return False
    while trans_gt and special_characters.find(trans_gt[0]) > -1:
        trans_gt = trans_gt[1:]
    while trans_det and special_characters.find(trans_det[0]) > -1:
        trans_det = trans_det[1:]
    while trans_gt and special_characters.find(trans_gt[-1]) > -1:
        trans_gt = trans_gt[:-1]
    while trans_det and special_characters.find(trans_det[-1]) > -1:
        trans_det = trans_det[:-1]
    return trans_gt == trans_det


# Character validity for word-spotting dictionary entries
# (text_eval_script.py:203-221): Latin letter ranges plus hyphen; the
# explicitly disallowed set is checked first (x/division signs fall inside
# the Latin-1 supplement range and must still be rejected).
_NOT_ALLOWED = "×÷·"  # × ÷ ·
_VALID_CHAR_RANGES = (
    (ord("a"), ord("z")),
    (ord("A"), ord("Z")),
    (0x00C0, 0x01BF),  # À–ƿ
    (0x01C4, 0x027F),  # Ǆ–ɿ
    (0x0386, 0x03FF),  # Ά–Ͽ
    (ord("-"), ord("-")),
)


def _dictionary_chars_valid(transcription: str) -> bool:
    for char in transcription:
        if char in _NOT_ALLOWED:
            return False
        code = ord(char)
        if not any(lo <= code <= hi for lo, hi in _VALID_CHAR_RANGES):
            return False
    return True


def include_in_dictionary(transcription: str) -> bool:
    """Word-spotting dictionary rule (text_eval_script.include_in_dictionary).

    Mirrors ``glass/evaluation/text_eval_script.py:180-221``: strip the
    ``'s`` suffix and edge hyphens, map special characters to spaces, reject
    inner spaces and short words, then require every remaining character to
    be a Latin-range letter or hyphen (digits and non-Latin scripts make the
    gt don't-care for word spotting).
    """
    if transcription[-2:] in ("'s", "'S"):
        transcription = transcription[:-2]
    transcription = transcription.strip("-")
    for ch in "'!?.:,*\"()·[]/":
        transcription = transcription.replace(ch, " ")
    transcription = transcription.strip()
    if len(transcription) != len(transcription.replace(" ", "")):
        return False
    if len(transcription) < MIN_LENGTH_CARE_WORD:
        return False
    return _dictionary_chars_valid(transcription)


def include_in_dictionary_transcription(transcription: str) -> str:
    if transcription[-2:] in ("'s", "'S"):
        transcription = transcription[:-2]
    transcription = transcription.strip("-")
    for ch in "'!?.:,*\"()·[]/":
        transcription = transcription.replace(ch, " ")
    return transcription.strip()


@dataclass
class EvalTotals:
    matched: int = 0
    det_only_matched: int = 0
    gt_care: int = 0
    det_care: int = 0
    det_only_gt_care: int = 0
    det_only_det_care: int = 0
    # Confidence-ranked AP accumulation (reference arrGlobalConfidences /
    # arrGlobalMatches, text_eval_script.py:259-260 — vestigial there; the
    # original RRC protocol fills one entry per care detection when the
    # CONFIDENCES evaluation param is on). None unless confidences=True.
    confidences: Optional[List[float]] = None
    match_flags: Optional[List[bool]] = None

    def add(self, other: "EvalTotals"):
        for f in (
            "matched",
            "det_only_matched",
            "gt_care",
            "det_care",
            "det_only_gt_care",
            "det_only_det_care",
        ):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        if other.confidences is not None:
            self.confidences = (self.confidences or []) + other.confidences
            self.match_flags = (self.match_flags or []) + other.match_flags


def evaluate_image(
    gts: Sequence[EvalInstance],
    dets: Sequence[EvalInstance],
    word_spotting: bool = False,
    detail: Optional[Dict[str, object]] = None,
    confidences: bool = False,
) -> EvalTotals:
    """One image's protocol totals.

    If ``detail`` is given (a dict) it is filled with the reference's
    per-sample debugging fields (text_eval_script.py:440-452): gt/det
    transcriptions, don't-care index lists, and the matched (gt, det)
    pairs of the E2E pass with their correctness.
    """
    gt_dontcare, det_only_gt_dontcare = [], []
    gt_trans = []
    for i, g in enumerate(gts):
        dontcare = det_only_dc = g.transcription == "###"
        trans = g.transcription
        if word_spotting and not dontcare:
            if not include_in_dictionary(trans):
                dontcare = True
            else:
                trans = include_in_dictionary_transcription(trans)
        gt_trans.append(trans)
        if dontcare:
            gt_dontcare.append(i)
        if det_only_dc:
            det_only_gt_dontcare.append(i)

    det_dontcare, det_only_det_dontcare = [], []
    for j, d in enumerate(dets):
        d_area = polygon_area(np.asarray(d.points, np.float64))
        for dc_list, out in (
            (gt_dontcare, det_dontcare),
            (det_only_gt_dontcare, det_only_det_dontcare),
        ):
            for i in dc_list:
                inter = polygon_intersection_area(gts[i].points, d.points)
                precision = 0 if d_area == 0 else inter / d_area
                if precision > AREA_PRECISION_CONSTRAINT:
                    out.append(j)
                    break

    n_gt, n_det = len(gts), len(dets)
    det_correct = det_only_correct = 0
    pairs: List[Dict[str, object]] = []
    det_matched_nums: List[int] = []  # E2E-correct detections (ref detMatchedNums)
    if n_gt and n_det:
        iou = pairwise_polygon_iou(
            [g.points for g in gts], [d.points for d in dets]
        )

        gt_matched = np.zeros(n_gt, bool)
        det_matched = np.zeros(n_det, bool)
        for i in range(n_gt):
            for j in range(n_det):
                if (
                    not gt_matched[i]
                    and not det_matched[j]
                    and i not in gt_dontcare
                    and j not in det_dontcare
                    and iou[i, j] > IOU_CONSTRAINT
                ):
                    gt_matched[i] = True
                    det_matched[j] = True
                    gt_word = gt_trans[i].upper().replace("####", "")
                    pred_word = dets[j].transcription.upper()
                    if word_spotting:
                        correct = edit_distance(gt_word, pred_word) <= 0
                    else:
                        try:
                            correct = transcription_match(gt_word, pred_word)
                        except Exception:
                            correct = False
                    det_correct += 1 if correct else 0
                    if correct:
                        det_matched_nums.append(j)
                    pairs.append(
                        {"gt": i, "det": j, "correct": bool(correct)}
                    )

        gt_matched[:] = False
        det_matched[:] = False
        for i in range(n_gt):
            for j in range(n_det):
                if (
                    not gt_matched[i]
                    and not det_matched[j]
                    and i not in det_only_gt_dontcare
                    and j not in det_only_det_dontcare
                    and iou[i, j] > IOU_CONSTRAINT
                ):
                    gt_matched[i] = True
                    det_matched[j] = True
                    det_only_correct += 1

    conf_list: Optional[List[float]] = None
    match_list: Optional[List[bool]] = None
    if confidences:
        # Original RRC CONFIDENCES accumulation: one (confidence, matched)
        # entry per care detection; "matched" here means matched AND
        # E2E-correct (the reference's detMatchedNums only records correct
        # matches, text_eval_script.py:399-400).
        conf_list, match_list = [], []
        for j, d in enumerate(dets):
            if j in det_dontcare:
                continue
            conf_list.append(float(d.confidence))
            match_list.append(j in det_matched_nums)

    if detail is not None:
        detail["gt_trans"] = list(gt_trans)
        detail["det_trans"] = [d.transcription for d in dets]
        detail["gt_dont_care"] = list(gt_dontcare)
        detail["det_dont_care"] = list(det_dontcare)
        detail["pairs"] = pairs

    return EvalTotals(
        matched=det_correct,
        det_only_matched=det_only_correct,
        gt_care=n_gt - len(gt_dontcare),
        det_care=n_det - len(det_dontcare),
        det_only_gt_care=n_gt - len(det_only_gt_dontcare),
        det_only_det_care=n_det - len(det_only_det_dontcare),
        confidences=conf_list,
        match_flags=match_list,
    )


def _prh(matched, gt_care, det_care):
    recall = 0.0 if gt_care == 0 else matched / gt_care
    precision = 0.0 if det_care == 0 else matched / det_care
    hmean = (
        0.0
        if precision + recall == 0
        else 2.0 * precision * recall / (precision + recall)
    )
    return {"precision": precision, "recall": recall, "hmean": hmean}


def _prh_per_sample(matched, gt_care, det_care):
    """Per-IMAGE P/R/H with the reference's zero-care convention
    (text_eval_script.py:415-421): an image with no care gts counts
    recall 1 (nothing to find), and precision 1 only when there are no
    care detections either.  Dataset totals never use this — they divide
    the global sums (``_prh``)."""
    if gt_care == 0:
        recall = 1.0
        precision = 0.0 if det_care > 0 else 1.0
    else:
        recall = matched / gt_care
        precision = 0.0 if det_care == 0 else matched / det_care
    hmean = (
        0.0
        if precision + recall == 0
        else 2.0 * precision * recall / (precision + recall)
    )
    return {"precision": precision, "recall": recall, "hmean": hmean}


def compute_ap(confidences, matches, num_gt_care: int) -> float:
    """Average precision over confidence-ranked detections
    (text_eval_script.py:124-142).  Wired into :func:`evaluate_dataset`
    behind its ``confidences`` flag (TEST.CONFIDENCES); the reference
    declares the accumulation arrays but its shipped configs never enable
    the flag, so there the lists stay empty."""
    if len(confidences) == 0:
        return 0.0
    order = np.argsort(-np.asarray(confidences, np.float64))
    matches = np.asarray(matches, bool)[order]
    correct = 0
    ap = 0.0
    for n, match in enumerate(matches):
        if match:
            correct += 1
            ap += correct / (n + 1)
    if num_gt_care > 0:
        ap /= num_gt_care
    return ap


def per_sample_detail(totals: EvalTotals) -> Dict[str, object]:
    """Per-image metric record (reference perSampleMetrics,
    text_eval_script.py:368-452 — the standard debugging artifact for
    hmean regressions)."""
    detail = {
        "matched": totals.matched,
        "det_only_matched": totals.det_only_matched,
        "gt_care": totals.gt_care,
        "det_care": totals.det_care,
        "det_only_gt_care": totals.det_only_gt_care,
        "det_only_det_care": totals.det_only_det_care,
    }
    detail["e2e"] = _prh_per_sample(
        totals.matched, totals.gt_care, totals.det_care
    )
    detail["detection_only"] = _prh_per_sample(
        totals.det_only_matched, totals.det_only_gt_care, totals.det_only_det_care
    )
    if totals.confidences is not None:
        detail["AP"] = compute_ap(
            totals.confidences, totals.match_flags, totals.gt_care
        )
    return detail


def evaluate_dataset(
    gt_per_image: Dict[str, List[EvalInstance]],
    det_per_image: Dict[str, List[EvalInstance]],
    word_spotting: bool = False,
    per_sample: Optional[Dict[str, Dict]] = None,
    confidences: bool = False,
) -> Dict[str, Dict[str, float]]:
    """Protocol totals over all images.

    If ``per_sample`` is given (a dict), it is filled with one
    :func:`per_sample_detail` record per image key — the protocol totals are
    unchanged by the extra bookkeeping.

    With ``confidences=True`` (the RRC CONFIDENCES evaluation param —
    declared but never enabled by the reference's shipped configs,
    text_eval_script.py:35,259-260), every care detection's confidence and
    E2E correctness are accumulated globally and ``E2E_RESULTS['AP']`` is
    the confidence-ranked average precision; per-sample records carry their
    own ``AP``.
    """
    totals = EvalTotals()
    for key, gts in gt_per_image.items():
        dets = det_per_image.get(key, [])
        extra: Optional[Dict[str, object]] = (
            {} if per_sample is not None else None
        )
        image_totals = evaluate_image(
            gts, dets, word_spotting, detail=extra, confidences=confidences
        )
        if per_sample is not None:
            record = per_sample_detail(image_totals)
            record.update(extra or {})
            per_sample[key] = record
        totals.add(image_totals)
    results = {
        "E2E_RESULTS": _prh(totals.matched, totals.gt_care, totals.det_care),
        "DETECTION_ONLY_RESULTS": _prh(
            totals.det_only_matched, totals.det_only_gt_care, totals.det_only_det_care
        ),
    }
    if confidences:
        results["E2E_RESULTS"]["AP"] = compute_ap(
            totals.confidences or [], totals.match_flags or [], totals.gt_care
        )
    return results
