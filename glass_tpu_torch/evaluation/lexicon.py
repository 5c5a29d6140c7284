"""Lexicon-based transcription correction — the full benchmark protocol.

Re-implements reference ``glass/evaluation/lexicon_utils.py`` (MTSv3-style)
with the internal hardcoded EFS paths replaced by config/CLI parameters:

* ``find_match_word`` (reference ``lexicon_utils.py:4-48``): closest lexicon
  word by plain upper-cased Levenshtein distance, or — when weighted — by
  the MTSv3 confidence-weighted edit distance over a plain-ED shortlist
  (``ed <= min_ed + 2``), returning the cased ground-truth form from the
  pairs file.
* ``weighted_edit_distance`` (``lexicon_utils.py:136-181``): dp where
  deleting/inserting a predicted char costs its predicted probability and
  substitution costs ``max(1 - p(lexicon_char)/p(pred_char)*5, 0)``.
* ``LexiconSet`` (``lexicon_utils.py:51-133`` + ``text_evaluator.py:76-81,
  183-204``): lexicon_type 0 none / 1 generic / 2 weak / 3 per-image strong
  (ICDAR15 ``new_voc_img_<i>.txt`` / ``pair_voc_img_<i>.txt``); a word is
  replaced when ``match_dist < EDIT_DISTANCE_THR`` (or always for the
  generic type) and **dropped** otherwise.

Scalability additions over the reference (which is O(dict x query) per
word): unweighted search iterates length buckets in order of |len - qlen|
and stops once the bucket's length difference can no longer beat the best
distance (Levenshtein >= length difference), and per-(query, lexicon)
results are memoized — TextOCR-scale generic lexicons (90k words) stay
tractable.

A copy of ``glass_tpu/evaluation/lexicon.py`` whose plain edit distance is
its own exact dynamic program (``edit_distance``), in place of the
``python-Levenshtein`` package, so the evaluator needs no package beyond
numpy and cv2.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance: the fewest single-character insertions,
    deletions and substitutions that turn ``a`` into ``b`` (unit costs,
    case-sensitive), one row of the dynamic program at a time."""
    if a == b:
        return 0
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def weighted_edit_distance(
    word1: str, word2: str, scores: np.ndarray, char_encode: Callable[[str], int]
) -> float:
    """MTSv3 confidence-weighted edit distance (lexicon_utils.py:136-181).

    word1: predicted string; word2: lexicon candidate; scores: (T, V)
    per-decoding-step class probabilities for word1; char_encode: codec
    char -> class index.
    """
    m, n = len(word1), len(word2)
    dp = np.zeros((n + 1, m + 1), np.float64)
    dp[0, :] = np.arange(m + 1)
    dp[:, 0] = np.arange(n + 1)

    def delete_cost(j):  # delete predicted word1[j]
        return scores[j][char_encode(word1[j])]

    def insert_cost(j):  # insert at predicted position j (reference's arg swap)
        c1 = char_encode(word1[j])
        if j < m - 1:
            c2 = char_encode(word1[j + 1])
            return (scores[j][c1] + scores[j + 1][c2]) / 2.0
        return scores[j][c1]

    def replace_cost(j, i):  # replace word1[j] with word2[i]
        c1 = char_encode(word1[j])
        c2 = char_encode(word2[i])
        return max(1.0 - scores[j][c2] / scores[j][c1] * 5.0, 0.0)

    for i in range(1, n + 1):
        for j in range(1, m + 1):
            if word1[j - 1].upper() != word2[i - 1].upper():
                rep = replace_cost(j - 1, i - 1)
            else:
                rep = 0.0
            dp[i, j] = min(
                dp[i - 1, j] + insert_cost(j - 1),
                dp[i, j - 1] + delete_cost(j - 1),
                dp[i - 1, j - 1] + rep,
            )
    return float(dp[n, m])


def _length_buckets(upper_words: Sequence[str]) -> Dict[int, List[int]]:
    buckets: Dict[int, List[int]] = {}
    for i, w in enumerate(upper_words):
        buckets.setdefault(len(w), []).append(i)
    return buckets


def find_match_word(
    rec_str: str,
    lexicon: Sequence[str],
    pairs: Dict[str, str],
    scores: Optional[np.ndarray] = None,
    weighted_ed: bool = False,
    char_encode: Optional[Callable[[str], int]] = None,
    _buckets: Optional[Dict[int, List[int]]] = None,
    _upper: Optional[Sequence[str]] = None,
) -> Tuple[str, float]:
    """Closest lexicon word (reference lexicon_utils.find_match_word).

    Returns (pairs[match], distance).  Distance is plain Levenshtein for the
    unweighted mode and the weighted edit distance otherwise (computed over
    a plain-ED shortlist ``ed <= min_ed + 2``, as in MTSv3).
    """
    upper = _upper if _upper is not None else [w.upper() for w in lexicon]
    q = rec_str.upper()
    buckets = _buckets if _buckets is not None else _length_buckets(upper)

    # Plain-ED scan, length-bucket pruned: |len(w) - len(q)| lower-bounds ED.
    best_plain, best_idx = 10**9, -1
    for diff, length in sorted((abs(L - len(q)), L) for L in buckets):
        if diff >= best_plain:
            break
        for i in buckets[length]:
            d = edit_distance(q, upper[i])
            if d < best_plain:
                best_plain, best_idx = d, i

    if not weighted_ed or scores is None:
        if best_idx < 0:
            return rec_str, float(10**9)
        return pairs.get(upper[best_idx], lexicon[best_idx]), float(best_plain)

    # Weighted: shortlist by plain ED <= best + 2, then weighted distance.
    best_w, best_word = float(10**9), rec_str
    scores = np.asarray(scores, np.float64)
    for diff, length in sorted((abs(L - len(q)), L) for L in buckets):
        if diff > best_plain + 2:
            break
        for i in buckets[length]:
            if edit_distance(q, upper[i]) > best_plain + 2:
                continue
            d = weighted_edit_distance(rec_str, upper[i], scores, char_encode)
            if d < best_w:
                best_w = d
                best_word = pairs.get(upper[i], lexicon[i])
    return best_word, best_w


def load_pairs_file(path: str) -> Dict[str, str]:
    """``<word> <gt form>`` lines -> dict UPPER(word) -> gt form
    (reference get_lexicon pair-list parsing)."""
    pairs: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            word = line.split(" ")[0]
            pairs[word.upper()] = line[len(word) + 1:]
    return pairs


def load_lexicon_file(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


class LexiconSet:
    """The three-condition benchmark lexicon protocol.

    lexicon_type: 0 none, 1 generic, 2 weak, 3 strong (per-image).
    ``correct`` returns the corrected word, or ``None`` when the word must
    be dropped (no lexicon entry within EDIT_DISTANCE_THR and type != 1,
    reference text_evaluator.py:197-201).
    """

    def __init__(
        self,
        lexicon_type: int = 0,
        words: Optional[Sequence[str]] = None,
        pairs: Optional[Dict[str, str]] = None,
        strong_dir: Optional[str] = None,
        strong_lexicon_pattern: str = "new_voc_img_{}.txt",
        strong_pairs_pattern: str = "pair_voc_img_{}.txt",
        weighted: bool = False,
        edit_distance_thr: float = 1.5,
    ):
        self.lexicon_type = int(lexicon_type)
        self.weighted = weighted
        self.edit_distance_thr = edit_distance_thr
        self.strong_dir = strong_dir
        self.strong_lexicon_pattern = strong_lexicon_pattern
        self.strong_pairs_pattern = strong_pairs_pattern
        self._per_image: Dict[str, tuple] = {}
        self._memo: Dict[tuple, Optional[str]] = {}
        self.words = list(words) if words else []
        if self.words:
            self.pairs = dict(pairs) if pairs else {w.upper(): w for w in self.words}
            self._upper = [w.upper() for w in self.words]
            self._buckets = _length_buckets(self._upper)
        else:
            self.pairs, self._upper, self._buckets = {}, [], {}

    @classmethod
    def from_config(cls, cfg) -> Optional["LexiconSet"]:
        t = cfg.TEST.LEXICON_TYPE
        if not t:
            return None
        words, pairs = None, None
        if t in (1, 2):
            if not cfg.TEST.LEXICON_PATH:
                raise ValueError(
                    f"TEST.LEXICON_TYPE={t} requires TEST.LEXICON_PATH"
                )
            words = load_lexicon_file(cfg.TEST.LEXICON_PATH)
            if cfg.TEST.LEXICON_PAIRS_PATH:
                pairs = load_pairs_file(cfg.TEST.LEXICON_PAIRS_PATH)
        elif t == 3 and not cfg.TEST.STRONG_LEXICON_DIR:
            raise ValueError("TEST.LEXICON_TYPE=3 requires TEST.STRONG_LEXICON_DIR")
        return cls(
            lexicon_type=t,
            words=words,
            pairs=pairs,
            strong_dir=cfg.TEST.STRONG_LEXICON_DIR or None,
            weighted=cfg.TEST.LEXICON_WEIGHTED,
            edit_distance_thr=cfg.EDIT_DISTANCE_THR,
        )

    # -- per-image strong lexicons ------------------------------------------
    def _load_strong(self, image_id: str):
        key = str(image_id)
        if key in self._per_image:
            return self._per_image[key]
        lex_path = os.path.join(self.strong_dir, self.strong_lexicon_pattern.format(key))
        pair_path = os.path.join(self.strong_dir, self.strong_pairs_pattern.format(key))
        if not os.path.exists(lex_path):
            logger.warning("no strong lexicon for image %s (%s)", key, lex_path)
            entry = ([], {}, [], {})
        else:
            words = load_lexicon_file(lex_path)
            pairs = (load_pairs_file(pair_path) if os.path.exists(pair_path)
                     else {w.upper(): w for w in words})
            upper = [w.upper() for w in words]
            entry = (words, pairs, upper, _length_buckets(upper))
        self._per_image[key] = entry
        return entry

    def _tables(self, image_id):
        if self.lexicon_type == 3:
            return self._load_strong(image_id)
        return self.words, self.pairs, self._upper, self._buckets

    def correct(
        self,
        text: str,
        image_id: Optional[str] = None,
        char_probs: Optional[np.ndarray] = None,
        char_encode: Optional[Callable[[str], int]] = None,
    ) -> Optional[str]:
        """-> corrected word, or None to drop the detection."""
        if not text:
            return None if self.lexicon_type != 1 else text
        words, pairs, upper, buckets = self._tables(image_id)
        if not words:
            return None if self.lexicon_type != 1 else text
        memo_key = (text, str(image_id) if self.lexicon_type == 3 else None,
                    self.weighted)
        if not self.weighted and memo_key in self._memo:
            return self._memo[memo_key]
        match, dist = find_match_word(
            text, words, pairs, scores=char_probs,
            weighted_ed=self.weighted, char_encode=char_encode,
            _buckets=buckets, _upper=upper,
        )
        out = match if (dist < self.edit_distance_thr or self.lexicon_type == 1) else None
        if not self.weighted:
            self._memo[memo_key] = out
        return out


def match_transcript(transcription: str, word_spotting: bool) -> str:
    """Det-side transcript normalization applied when a lexicon or word
    spotting is active (reference text_evaluator.match_transcript)."""
    special = "'!?.:,*+\"()·[]/\\#$%;<=>@^_`{|}~"
    if word_spotting:
        if transcription[-2:] in ("'s", "'S"):
            transcription = transcription[:-2]
        transcription = transcription.strip("-")
        for ch in special:
            transcription = transcription.replace(ch, " ")
        return transcription.strip()
    if transcription and special.find(transcription[0]) > -1:
        transcription = transcription[1:]
    if transcription and special.find(transcription[-1]) > -1:
        transcription = transcription[:-1]
    return transcription


class Lexicon:
    """Single-file lexicon (CLI ``--lexicon``) — kept as a thin adapter over
    the protocol machinery for ad-hoc use; corrections that exceed
    ``max_distance`` keep the original text instead of dropping it."""

    def __init__(
        self,
        words: Sequence[str],
        weighted: bool = False,
        max_distance: float = 2.5,
        case_sensitive: bool = False,
    ):
        self.words = list(words)
        self.weighted = weighted
        self.max_distance = max_distance
        self.case_sensitive = case_sensitive
        self._upper = [w.upper() for w in self.words]
        self._buckets = _length_buckets(self._upper)
        self._pairs = {u: w for u, w in zip(self._upper, self.words)}

    @classmethod
    def from_file(cls, path: str, **kwargs) -> "Lexicon":
        return cls(load_lexicon_file(path), **kwargs)

    def correct(self, text: str, char_scores=None, codec=None) -> str:
        if not self.words or not text:
            return text
        char_encode = getattr(codec, "char_encode", None)
        weighted = self.weighted and char_scores is not None and char_encode
        match, dist = find_match_word(
            text, self.words, self._pairs,
            scores=np.asarray(char_scores) if weighted else None,
            weighted_ed=bool(weighted), char_encode=char_encode,
            _buckets=self._buckets, _upper=self._upper,
        )
        return match if dist <= self.max_distance else text
