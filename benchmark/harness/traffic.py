"""The one generator of the benchmark's inputs, read from a traffic file
(``benchmark/traffic/<mix>.json``) and the run's seed.

Every seed gets the same work in another order: a mix's scenes (or
training batches) come from the mix's own fixed ``scene_seed`` (or
``batch_seed``), and the run's ``--seed`` draws their order, the answers
compared with the reference and the training step's random draws.  (With
the scenes and the weights drawn from ``--seed``, three seeds of the
one-image cell read p90s of 180-366 ms: a random model's boxes, and with
them the host's merges and mask polygons, change with its weights.)

Scenes are the glyph-word scenes of the repository's bring-up checks
(``chip_smoke.write_eval_set``: 7x5 glyph words, one text line per band,
on a noisy dark background), made in memory.  Training batches are
``tools/train_bench.py``'s ``make_batch``: noise images and seeded rotated
word boxes with five random characters each, the first ``gts`` slots of
``TPU.MAX_GT_INSTANCES`` valid.  Both take a seed of any size.
"""

from __future__ import annotations

import cv2
import numpy as np
import torch

from ..reference.glass.ops.boxes import boxes_to_polygons

GLYPHS = {
    "a": ["11111", "10001", "10001", "11111", "10001", "10001", "10001"],
    "b": ["11110", "10001", "11110", "10001", "10001", "10001", "11110"],
    "c": ["01110", "10000", "10000", "10000", "10000", "10000", "01110"],
    "d": ["00100", "00100", "01110", "00100", "00100", "00100", "00100"],
    "e": ["10001", "01010", "00100", "00100", "00100", "01010", "10001"],
    "f": ["00100", "01110", "10101", "00100", "00100", "00100", "00100"],
}
GLYPH_WORDS = ["ace", "bdf", "fab", "ecd", "bad", "cafe", "face", "deaf"]


def rng(seed: int, stream: int) -> np.random.Generator:
    """The run's generator for one purpose (``stream``)."""
    return np.random.default_rng([int(seed) % (2 ** 64), stream])


def render_word(word: str, scale: int) -> np.ndarray:
    img = np.zeros((7 * scale, 6 * len(word) * scale), np.uint8)
    for i, ch in enumerate(word):
        g = np.array([[int(c) for c in row] for row in GLYPHS[ch]], np.uint8)
        g = cv2.resize(g * 255, (5 * scale, 7 * scale), interpolation=cv2.INTER_NEAREST)
        img[:, i * 6 * scale: i * 6 * scale + 5 * scale] = g
    return img


def glyph_scene(r: np.random.Generator, hw, rendered) -> np.ndarray:
    """One BGR uint8 scene of glyph words (``write_eval_set``'s layout)."""
    h, w = hw
    scale = max(1, h // 100)
    img = r.integers(30, 70, (h, w, 3), dtype=np.uint8)
    band = 7 * scale + 12 * scale
    pad = max(2, scale)
    for y0 in range(4 * scale, h - band, band):
        x0 = int(r.integers(3 * scale, 20 * scale))
        while True:
            glyph = rendered[GLYPH_WORDS[int(r.integers(len(GLYPH_WORDS)))]]
            gh, gw = glyph.shape
            if x0 + gw + pad >= w:
                break
            img[y0 - pad: y0 + gh + pad, x0 - pad: x0 + gw + pad] = 0
            img[y0: y0 + gh, x0: x0 + gw] = glyph[..., None]
            x0 += gw + int(r.integers(6 * scale, 40 * scale))
    return img


def scene_pool(mix: dict, seed: int):
    """(the mix's ``pool`` scenes of ``hw`` from its ``scene_seed``, the
    run's order of them drawn from ``seed``)."""
    hw = tuple(mix["hw"])
    scale = max(1, hw[0] // 100)
    rendered = {wd: render_word(wd, scale) for wd in GLYPH_WORDS}
    r = rng(int(mix["scene_seed"]), 1)
    pool = [glyph_scene(r, hw, rendered) for _ in range(int(mix["pool"]))]
    return pool, order(seed, len(pool))


def order(seed: int, n: int) -> list:
    """The run's order of a pool of ``n``, drawn from its seed."""
    return [int(i) for i in rng(seed, 4).permutation(n)]


def train_batch(r: np.random.Generator, b, h, w, g_real, g_cap, max_word_len) -> dict:
    """``make_batch`` of ``tools/train_bench.py``: b noise images, g_cap
    rotated word boxes per image of which the first g_real are valid, five
    random characters a word, the boxes' corners as 16-vertex polygons."""
    boxes = np.stack([
        r.uniform(64, w - 64, (b, g_cap)),
        r.uniform(64, h - 64, (b, g_cap)),
        r.uniform(24, 180, (b, g_cap)),
        r.uniform(10, 40, (b, g_cap)),
        r.uniform(-60, 60, (b, g_cap)),
    ], axis=-1).astype(np.float32)
    valid = np.zeros((b, g_cap), bool)
    valid[:, :g_real] = True
    text = np.zeros((b, g_cap, max_word_len + 2), np.int64)
    text[..., 1:6] = r.integers(1, 60, (b, g_cap, 5))
    polys = np.zeros((b, g_cap, 16, 2), np.float32)
    polys[:, :, :4] = boxes_to_polygons(torch.from_numpy(boxes)).numpy()
    return {
        "images": (r.random((b, h, w, 3), dtype=np.float32) * 255).astype(np.float32),
        "content_hw": np.tile([[h, w]], (b, 1)).astype(np.int32),
        "gt_boxes": boxes,
        "gt_valid": valid,
        "gt_classes": np.zeros((b, g_cap), np.int32),
        "gt_orientation": r.integers(0, 4, (b, g_cap)).astype(np.int32),
        "gt_text": text,
        "gt_polygons": polys,
        "gt_poly_nv": np.full((b, g_cap), 4, np.int32),
    }


def train_pool(mix: dict, seed: int, g_cap: int, max_word_len: int):
    """(the mix's ``pool`` training batches, each ``batch`` images of
    ``size`` squared with ``gts`` words, from its ``batch_seed``; the run's
    order of them drawn from ``seed``)."""
    r = rng(int(mix["batch_seed"]), 2)
    s = int(mix["size"])
    pool = [train_batch(r, int(mix["batch"]), s, s, int(mix["gts"]), g_cap, max_word_len)
            for _ in range(int(mix["pool"]))]
    return pool, order(seed, len(pool))


def sample(seed: int, among: int, k: int) -> list:
    """``k`` distinct indices below ``among``, drawn from the seed: the
    answers the run compares with the reference."""
    return sorted(int(i) for i in rng(seed, 3).choice(among, size=min(k, among), replace=False))
