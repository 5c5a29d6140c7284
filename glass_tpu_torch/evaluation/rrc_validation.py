"""Strict RRC submission-file validation.

Port of the official harness's validation layer (reference
``glass/evaluation/rrc_evaluation_funcs.py:51-310`` and the
``validate_data`` step of ``text_eval_script.py:40-62``): external det/gt
zip files are checked entry-by-entry and line-by-line BEFORE evaluation,
and malformed input is rejected with the reference's per-line error
message (``"Line in sample not valid. Sample: %s Line: %s Error: %s"``)
instead of being silently skipped or mis-parsed.

Two line dialects, selected exactly as the reference selects them
(``text_eval_script.py:46``: 'totaltext' when the gt path mentions
totaltext/textocr, else 'icdar'):

* ``icdar``  gt:  ``x1,y1,...,x4,y4,transcription`` — 8 integer coords
  (reference ``get_tl_line_values_gt``, ``rrc_evaluation_funcs.py:208-217``)
* ``totaltext`` gt: ``x1,y1,...,xn,yn,####transcription`` — any even
  number of float coords (``:203-206``)
* det (both):  ``x1,y1,...,xn,yn,####transcription``
  (``get_tl_line_values`` with LTRB=False + withTranscription,
  ``rrc_evaluation_funcs.py:264-283``)

Deliberate deviation: line splitting accepts both CRLF and LF (the
reference splits on exactly one, ``:105``, so LF files collapse to a
single unparseable line under its CRLF default); the accepted *content*
per line is identical.
"""

from __future__ import annotations

import codecs
import re
import zipfile
from typing import Dict, List, Optional, Tuple


def load_zip_file(
    path: str, name_regexp: str = "", all_entries: bool = False
) -> Dict[str, bytes]:
    """Read a zip into {key: contents}, keyed by the regexp's first group.

    Reference ``rrc_evaluation_funcs.py:51-80``: entries not matching the
    regexp are skipped, unless ``all_entries`` — then they are an error
    (used for det submissions, where every entry must be a result file).
    """
    try:
        archive = zipfile.ZipFile(path, mode="r", allowZip64=True)
    except Exception:
        raise ValueError("Error loading the ZIP archive")
    pairs = []
    for name in archive.namelist():
        key: Optional[str] = name
        if name_regexp:
            m = re.match(name_regexp, name)
            if m is None:
                key = None
            elif m.groups():
                key = m.group(1)
        if key is not None:
            pairs.append((key, archive.read(name)))
        elif all_entries:
            raise ValueError("ZIP entry not valid: %s" % name)
    return dict(pairs)


def decode_utf8(raw: bytes) -> Optional[str]:
    """UTF-8 decode with BOM strip; None on failure (reference ``:82-94``)."""
    try:
        if raw.startswith(codecs.BOM_UTF8):
            raw = raw[len(codecs.BOM_UTF8):]
        return raw.decode("utf-8")
    except Exception:
        return None


def _split_lines(text: str) -> List[str]:
    return text.replace("\r\n", "\n").replace("\r", "\n").split("\n")


def _unquote_transcription(transcription: str) -> str:
    """Reference ``:249-252``: double-quoted transcriptions are unwrapped
    and their escaped characters restored."""
    m = re.match(r'^\s*\"(.*)\"\s*$', transcription)
    if m is not None:
        return m.group(1).replace("\\\\", "\\").replace('\\"', '"')
    return transcription


_ICDAR_GT_RE = re.compile(
    r"^\s*(-?[0-9]+)\s*,\s*(-?[0-9]+)\s*,\s*(-?[0-9]+)\s*,\s*(-?[0-9]+)\s*,"
    r"\s*(-?[0-9]+)\s*,\s*(-?[0-9]+)\s*,\s*(-?[0-9]+)\s*,\s*(-?[0-9]+)\s*,(.*)$"
)


def get_tl_line_values_gt(
    line: str, line_format: str = "totaltext"
) -> Tuple[List[float], float, str]:
    """Parse + validate one gt line -> (points, confidence, transcription).

    Raises on malformed input (reference ``get_tl_line_values_gt``,
    ``rrc_evaluation_funcs.py:150-252``).
    """
    if line_format.startswith("icdar"):
        m = _ICDAR_GT_RE.match(line)
        if m is None:
            raise ValueError(
                "Format incorrect. Should be: x1,y1,x2,y2,x3,y3,x4,y4,transcription"
            )
        points = [float(m.group(i)) for i in range(1, 9)]
        transcription = m.group(9)
    else:  # totaltext / textocr free polygon
        ptr = line.strip().split(",####")
        if len(ptr) != 2:
            raise ValueError(
                "Format incorrect. Should be: x1,y1,...,xn,yn,####transcription"
            )
        cors = ptr[0].split(",")
        if len(cors) % 2 != 0:
            raise ValueError("num cors should be even.")
        points = [float(ic) for ic in cors]
        transcription = ptr[1].strip()
    if len(points) < 6:
        raise ValueError("a polygon needs at least 3 points, got %d" % (len(points) // 2))
    return points, 0.0, _unquote_transcription(transcription)


def get_tl_line_values_det(
    line: str, with_confidence: bool = False
) -> Tuple[List[float], float, str]:
    """Parse + validate one det line -> (points, confidence, transcription).

    Reference ``get_tl_line_values`` with LTRB=False + withTranscription
    (``rrc_evaluation_funcs.py:264-302``); its withConfidence branch raises
    'not implemented' and hard-codes confidence=1.0 — replicated.
    """
    ptr = line.strip().split(",####")
    if len(ptr) != 2:
        raise ValueError(
            "Format incorrect. Should be: x1,y1,...,xn,yn,####transcription"
        )
    cors = ptr[0].split(",")
    if len(cors) % 2 != 0:
        raise ValueError("num cors should be even.")
    points = [float(ic) for ic in cors]
    if len(points) < 6:
        raise ValueError("a polygon needs at least 3 points, got %d" % (len(points) // 2))
    confidence = 1.0 if with_confidence else 0.0
    return points, confidence, _unquote_transcription(ptr[1].strip())


def validate_lines_in_file_gt(
    file_name: str, contents: bytes, line_format: str = "totaltext"
) -> None:
    """Validate every gt line, reference error text (``:96-112``)."""
    text = decode_utf8(contents)
    if text is None:
        raise ValueError("The file %s is not UTF-8" % file_name)
    for line in _split_lines(text):
        line = line.replace("\r", "").replace("\n", "")
        if line:
            try:
                get_tl_line_values_gt(line, line_format)
            except Exception as e:
                raise ValueError(
                    "Line in sample not valid. Sample: %s Line: %s Error: %s"
                    % (file_name, line, e)
                )


def validate_lines_in_file(
    file_name: str, contents: bytes, with_confidence: bool = False
) -> None:
    """Validate every det line, reference error text (``:114-129``)."""
    text = decode_utf8(contents)
    if text is None:
        raise ValueError("The file %s is not UTF-8" % file_name)
    for line in _split_lines(text):
        line = line.replace("\r", "").replace("\n", "")
        if line:
            try:
                get_tl_line_values_det(line, with_confidence)
            except Exception as e:
                raise ValueError(
                    "Line in sample not valid. Sample: %s Line: %s Error: %s"
                    % (file_name, line, e)
                )


def line_format_for(gt_path_or_dataset: str) -> str:
    """The reference's dialect rule (``text_eval_script.py:46``)."""
    low = gt_path_or_dataset.lower()
    return "totaltext" if ("totaltext" in low or "textocr" in low) else "icdar"


def validate_submission(
    gt_zip: str,
    det_zip: str,
    gt_name_regexp: str = r"(?:.*[/\\])?gt_img_([0-9]+)\.txt$",
    det_name_regexp: str = r"(?:.*[/\\])?res_img_([0-9]+)\.txt$",
    line_format: Optional[str] = None,
    with_confidence: bool = False,
) -> Tuple[Dict[str, bytes], Dict[str, bytes]]:
    """The reference ``validate_data`` step (``text_eval_script.py:40-62``):
    load both zips, validate every gt line, require every det sample to
    exist in gt, validate every det line. Returns the loaded (gt, det)
    contents for the evaluator."""
    if line_format is None:
        line_format = line_format_for(gt_zip)
    gt = load_zip_file(gt_zip, gt_name_regexp)
    if not gt:
        raise ValueError("The GT zip %s contains no gt samples" % gt_zip)
    subm = load_zip_file(det_zip, det_name_regexp, all_entries=True)
    for k in gt:
        validate_lines_in_file_gt(k, gt[k], line_format)
    for k in subm:
        if k not in gt:
            raise ValueError("The sample %s not present in GT" % k)
        validate_lines_in_file(k, subm[k], with_confidence)
    return gt, subm
