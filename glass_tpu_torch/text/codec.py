"""String <-> index-tensor codec for the attention recognizer.

Re-implements the semantics of reference
``glass/modeling/recognition/text_encoder.py:8-179``:

* attention mode: tokens ``[GO], [s]`` prepended to the charset (released
  configs: 95 printable chars -> vocab 97); encoded words are
  ``[0, c1..ck, s_index, 0...]`` of length ``max_word_length + 2``,
* words with ``len >= max_word_length`` or in the ignore list collapse to
  the empty string,
* decoding masks everything after the first ``[s]`` and scores a word by
  the product of its per-character probabilities (including the stop symbol
  when requested),
* ctc mode collapses repeats and drops blanks.

Pure numpy — this runs on the host side of the input/output pipeline.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

GO_TOKEN = "[GO]"
STOP_TOKEN = "[s]"
UNK_TOKEN = "[UNK]"


class TextCodec:
    def __init__(
        self,
        character_set: str,
        max_word_length: int = 25,
        mode: str = "attention",
        unk_symbol: bool = False,
        ignore_text: Sequence[str] = ("###",),
        ignore_empty_text: bool = True,
    ):
        self.max_word_length = max_word_length
        self.mode = mode
        self.unk_symbol = unk_symbol
        self.ignore_text = list(ignore_text)
        self.ignore_empty_text = ignore_empty_text

        extra: List[str] = []
        if mode == "attention":
            extra += [GO_TOKEN, STOP_TOKEN]
        elif mode == "ctc":
            extra += ["[blank]"]
        else:
            raise NotImplementedError(mode)
        if unk_symbol:
            extra += [UNK_TOKEN]
        self.character: List[str] = extra + list(character_set)
        self.dict: Dict[str, int] = {c: i for i, c in enumerate(self.character)}
        self.stop_index = self.character.index(STOP_TOKEN) if mode == "attention" else None

    @classmethod
    def from_config(cls, cfg) -> "TextCodec":
        if cfg.MODEL.ROI_RECOGNIZER_HEAD.NAME == "RecognizerRCNNHeadV3":
            node = cfg.MODEL.ROI_RECOGNIZER_HEAD
        else:  # legacy checkpoints configure the recognizer via ROI_MASK_HEAD
            node = cfg.MODEL.ROI_MASK_HEAD
        return cls(
            character_set=node.CHARACTER_SET,
            max_word_length=node.MAX_WORD_LENGTH,
            mode=node.LABELS_TYPE,
            unk_symbol=node.UNK_SYMBOL_PRED,
            ignore_text=node.IGNORE_TEXT,
            ignore_empty_text=node.IGNORE_EMPTY_TEXT,
        )

    @property
    def vocab_size(self) -> int:
        return len(self.character)

    def char_encode(self, char: str) -> int:
        """Single char -> class index (reference text_encoder.py:76-78);
        unknown chars map to [UNK] when enabled, else to index 0."""
        assert len(char) == 1
        if char in self.dict:
            return self.dict[char]
        return self.dict[UNK_TOKEN] if self.unk_symbol else 0

    @property
    def encode_length(self) -> int:
        return self.max_word_length + (2 if self.mode == "attention" else 0)

    # -- encode -----------------------------------------------------------
    def encode(self, text_list: Sequence[Optional[str]]) -> np.ndarray:
        texts = [
            t if (t is not None) and (len(t) < self.max_word_length) else ""
            for t in text_list
        ]
        if self.ignore_text:
            assert self.ignore_empty_text, (
                "IGNORE_EMPTY_TEXT has to be True for non-empty IGNORE_TEXT"
            )
            texts = [t if t not in self.ignore_text else "" for t in texts]

        out = np.zeros((len(texts), self.encode_length), np.int64)
        shift = 1 if self.mode == "attention" else 0
        for i, t in enumerate(texts):
            chars = list(t)
            if self.mode == "attention":
                chars.append(STOP_TOKEN)
            if self.unk_symbol:
                enc = [self.dict.get(c, self.dict[UNK_TOKEN]) for c in chars]
            else:
                enc = [self.dict[c] for c in chars if c in self.dict]
            out[i, shift : shift + len(enc)] = enc
        return out

    # -- decode -----------------------------------------------------------
    def _mask_attention(
        self, pred_indices: np.ndarray, include_stop: bool = True
    ) -> np.ndarray:
        mask = (pred_indices == self.stop_index).cumsum(axis=1) < 1
        if include_stop:
            word_len = np.minimum(mask.sum(axis=1), mask.shape[1] - 1)
            mask[np.arange(len(word_len)), word_len] = True
        if self.unk_symbol:
            mask[pred_indices == self.character.index(UNK_TOKEN)] = False
        return mask

    def decode(
        self,
        pred_indices: np.ndarray,
        pred_probs: Optional[np.ndarray] = None,
        include_stop_symbol_conf: bool = True,
    ) -> List[dict]:
        if self.mode == "attention":
            return self._decode_attention(pred_indices, pred_probs, include_stop_symbol_conf)
        return self._decode_ctc(pred_indices, pred_probs)

    def _decode_attention(self, pred_indices, pred_probs, include_stop):
        pred_indices = np.asarray(pred_indices)
        mask = self._mask_attention(pred_indices, include_stop)
        if pred_probs is not None:
            pred_probs = np.asarray(pred_probs).copy()
            pred_probs[~mask] = 1
            word_probs = pred_probs.prod(axis=1)
        results = []
        for i, pred in enumerate(pred_indices):
            idx = pred[mask[i]]
            if include_stop and len(idx) and idx[-1] == self.stop_index:
                text = "".join(self.character[j] for j in idx[:-1])
            else:
                text = "".join(self.character[j] for j in idx)
            if pred_probs is not None:
                char_conf = pred_probs[i, mask[i]]
                word_conf = word_probs[i]
            else:
                char_conf = [1] * len(text)
                word_conf = 1
            results.append(
                {"text": text, "score": word_conf, "character_scores": char_conf}
            )
        return results

    def _decode_ctc(self, pred_indices, pred_probs):
        pred_indices = np.asarray(pred_indices)
        if pred_probs is None:
            pred_probs = np.ones_like(pred_indices, np.float32)
        results = []
        for t, prob in zip(pred_indices, pred_probs):
            chars, scores = [], []
            for i in range(self.max_word_length):
                if t[i] != 0:
                    if i > 0 and t[i - 1] == t[i]:
                        if scores[-1] < prob[i]:
                            scores[-1] = prob[i]
                    else:
                        scores.append(prob[i])
                        chars.append(
                            self.character[t[i]] if t[i] < len(self.character) else ""
                        )
            text = "".join(chars).replace(UNK_TOKEN, "")
            if scores:
                results.append(
                    {
                        "text": text,
                        "score": float(np.prod(scores)),
                        "character_scores": scores,
                    }
                )
            else:
                results.append({"text": text, "score": 1.0, "character_scores": [1.0]})
        return results


def decode_topk_ids(indices: np.ndarray, step_scores: np.ndarray, codec: TextCodec):
    """(N, T) argmax ids + (N, T) per-step max probs -> texts + scores.

    The on-device-argmax (``TPU.TEXT_EMIT = "topk"``) counterpart of
    ``decode_topk_probs`` — identical results, 12x less host traffic.
    """
    if len(indices) == 0:
        return [], [], []
    decoded = codec.decode(np.asarray(indices), np.asarray(step_scores, np.float32))
    texts = [d["text"] for d in decoded]
    word_scores = [float(d["score"]) for d in decoded]
    char_scores = [d["character_scores"] for d in decoded]
    return texts, word_scores, char_scores


def decode_instance_texts(preds, codec: TextCodec):
    """Dispatch on whichever recognizer representation the Instances carry."""
    if preds.has("pred_text_prob"):
        return decode_topk_probs(np.asarray(preds.pred_text_prob), codec)
    return decode_topk_ids(
        np.asarray(preds.pred_text_ids),
        np.asarray(preds.pred_text_step_scores),
        codec,
    )


def decode_topk_probs(pred_probs: np.ndarray, codec: TextCodec):
    """(N, T, V) probability tensors -> texts + scores, argmax decoding.

    Mirrors reference ``text_evaluator.get_instances_text``.
    """
    if len(pred_probs) == 0:
        return [], [], []
    pred_probs = np.asarray(pred_probs)
    scores = pred_probs.max(axis=2)
    indices = pred_probs.argmax(axis=2)
    decoded = codec.decode(indices, scores)
    texts = [d["text"] for d in decoded]
    word_scores = [float(d["score"]) for d in decoded]
    char_scores = [d["character_scores"] for d in decoded]
    return texts, word_scores, char_scores
