"""The native contour tracer (``native/contours.cpp``) against the cv2 calls
it replaces in the mask polygons' step: ``cv2.findContours(window,
RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` and ``max(contours,
key=cv2.contourArea)``, point for point, on seeded windows of every shape
the paster meets, and the paster's polygons with the tracer and with cv2.

The file imports no jax, so it runs on the card's host too, whose OpenCV
differs from this one: ``python3 -m pytest tests/test_torch_native_contours.py
--noconftest -p no:cacheprovider``."""

import os

import cv2
import numpy as np
import pytest
import torch

from glass_tpu_torch.native import build, load_contours
from glass_tpu_torch.postprocess import paste
from glass_tpu_torch.utils import trace

torch.set_num_threads(2)
native = pytest.mark.skipif(load_contours() is None, reason="the native contour tracer did not build")


def cv2_largest(window):
    """The step's cv2 reference (``paste._largest_contour`` at the origin)."""
    contours, _ = cv2.findContours(window, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return None
    largest = max(contours, key=cv2.contourArea).reshape(-1, 2)
    return None if len(largest) < 3 else largest


def assert_same(got, want, what=""):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (what, k)
        if g is not None:
            assert g.dtype == np.float64 and g.shape == w.shape, (what, k)
            assert np.array_equal(g, w), (what, k)


def noise(rng, h, w):
    return (rng.random((h, w)) < rng.uniform(0.05, 0.95)).astype(np.uint8)


def smooth(rng, h, w):
    """A mask head's look: a coarse grid of probabilities, warped up."""
    small = rng.random((int(rng.integers(2, 29)), int(rng.integers(2, 29)))).astype(np.float32)
    big = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
    return (big >= rng.uniform(0.2, 0.8)).astype(np.uint8)


def blocks(rng, h, w):
    """Rectangles and their holes, nested: rings, components in holes,
    lines one pixel wide, equal areas."""
    img = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(1, 12))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        y1, x1 = y0 + int(rng.integers(1, max(h // 2, 2))), x0 + int(rng.integers(1, max(w // 2, 2)))
        img[y0:y1, x0:x1] = rng.integers(0, 2)
    return img


def lines(rng, h, w):
    """Diagonal and straight strokes one pixel wide, and single pixels."""
    img = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(1, 8))):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        dy, dx = (int(v) for v in rng.integers(-1, 2, 2))
        for _ in range(int(rng.integers(1, 30))):
            if 0 <= y < h and 0 <= x < w:
                img[y, x] = 1
            y, x = y + dy, x + dx
    img[rng.random((h, w)) < 0.01] = 1
    return img


def ties(rng, h, w):
    """Copies of one shape at random places: every one of equal area."""
    img = np.zeros((h, w), np.uint8)
    sh, sw = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    shape = (rng.random((sh, sw)) < 0.7).astype(np.uint8)
    for _ in range(int(rng.integers(2, 10))):
        y, x = int(rng.integers(0, max(h - sh, 0) + 1)), int(rng.integers(0, max(w - sw, 0) + 1))
        img[y:y + sh, x:x + sw] |= shape[:h - y, :w - x]
    return img


KINDS = {"noise": noise, "smooth": smooth, "blocks": blocks, "lines": lines, "ties": ties}


def windows(kind, seed, n, max_side):
    rng = np.random.default_rng([seed, list(KINDS).index(kind)])
    out = []
    for k in range(n):
        h = int(rng.integers(1, max_side + 1))
        w = k % 48 + 1 if k % 2 else int(rng.integers(1, max_side + 1))  # every width mod 16
        out.append(KINDS[kind](rng, h, w))
    return out


@native
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", list(KINDS))
def test_tracer_equals_cv2_on_seeded_windows(kind, seed):
    """300 windows a case, 1x1 to 64x64, every width 1-48 among them."""
    wins = windows(kind, seed, 300, 64)
    got = paste._trace_windows(load_contours(), wins)
    assert_same(got, [cv2_largest(w) for w in wins], kind)
    assert sum(g is not None for g in got) > 30


@native
@pytest.mark.parametrize("kind", ["noise", "smooth", "blocks"])
def test_tracer_equals_cv2_on_large_windows(kind):
    """Windows up to 600x600, the size of the largest words."""
    wins = windows(kind, 7, 24, 600)
    wins.append(np.ones((600, 600), np.uint8))
    wins.append(np.zeros((600, 583), np.uint8))
    assert_same(paste._trace_windows(load_contours(), wins), [cv2_largest(w) for w in wins], kind)


def pack(wins):
    """Windows laid out as K3 writes them: 16-byte aligned offsets in one
    buffer, each with its foreground box (x1 < 0 where it has none)."""
    sizes = np.array([(w.size + 15) // 16 * 16 for w in wins], np.int64)
    geo = np.stack([np.cumsum(sizes) - sizes, [w.shape[1] for w in wins], [w.shape[0] for w in wins]],
                   1).astype(np.int64)
    base = np.full(int(sizes.sum()) + 16, 7, np.uint8)  # the gaps hold stray bytes
    fg = np.tile(np.int32([0, 0, -1, -1]), (len(wins), 1))
    for (off, w, h), win, box in zip(geo, wins, fg):
        base[off:off + w * h] = win.ravel()
        ys, xs = np.nonzero(win)
        if len(ys):
            box[:] = xs.min(), ys.min(), xs.max(), ys.max()
    return base, geo, fg


@native
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracer_over_foreground_boxes_equals_cv2_on_whole_windows(seed):
    """The paster's call: windows packed as K3 writes them, each read only
    inside its foreground box; shifted by the box's corner, the points are
    cv2's on the whole window.  Skipped words read 0."""
    rng = np.random.default_rng(seed)
    wins = []
    for k in range(200):
        h, w = int(rng.integers(1, 120)), int(rng.integers(1, 120))
        img = np.zeros((h, w), np.uint8)
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        y1, x1 = int(rng.integers(y0, h)) + 1, int(rng.integers(x0, w)) + 1
        img[y0:y1, x0:x1] = KINDS[list(KINDS)[k % len(KINDS)]](rng, y1 - y0, x1 - x0)
        wins.append(img)
    base, geo, fg = pack(wins)
    skip = (rng.random(len(wins)) < 0.1).astype(np.int32)
    counts = np.full(len(wins), 99, np.int32)
    points = np.zeros((1 << 16, 2), np.int32)
    need = load_contours().largest(base, geo, fg, skip, points, counts)
    assert need == counts.sum() and need < len(points)
    got = paste._split(points, counts, fg[:, :2].astype(np.int64))
    want = [None if s else cv2_largest(w) for w, s in zip(wins, skip)]
    assert_same(got, want)
    assert all(c == 0 for c, s in zip(counts, skip) if s)


@native
def test_tracer_reports_what_does_not_fit():
    """Points beyond the capacity: those words read -1, the call returns
    what all need, and a call with that room gives every word."""
    wins = windows("smooth", 3, 40, 80)
    base, geo, fg = pack(wins)
    tracer = load_contours()
    counts = np.zeros(len(wins), np.int32)
    small = np.zeros((50, 2), np.int32)
    need = tracer.largest(base, geo, fg, None, small, counts)
    assert need > 50 and (counts == -1).any() and counts[counts > 0].sum() <= 50
    points = np.zeros((need, 2), np.int32)
    assert tracer.largest(base, geo, fg, None, points, counts) == need == counts.sum()
    assert_same(paste._split(points, counts, fg[:, :2].astype(np.int64)), [cv2_largest(w) for w in wins])
    with pytest.raises(ValueError):
        tracer.largest(base, geo.astype(np.int32), fg, None, points, counts)
    with pytest.raises(ValueError, match="outside the buffer"):
        tracer.largest(base[:-200], geo, fg, None, points, counts)
    wide = fg.copy()
    wide[np.argmax(fg[:, 2] >= 0), 2] = geo[np.argmax(fg[:, 2] >= 0), 1]
    with pytest.raises(ValueError, match="outside its window"):
        tracer.largest(base, geo, wide, None, points, counts)


@native
def test_native_contours_builds_in_the_build_dir_and_passes_the_probe():
    assert paste.native_contours() is load_contours()
    path = build.library_path(build._CONTOURS_SRC)
    assert os.path.dirname(path) == build.build_dir() and os.path.exists(path)
    assert os.path.basename(path).startswith("libcontours-")
    wins = paste._probe_windows()
    assert_same(paste._trace_windows(load_contours(), wins), [cv2_largest(w) for w in wins])


class Planted:
    """The real tracer with one point moved, in the first window that has
    a contour of more than 3 points."""

    def __init__(self, tracer):
        self.tracer = tracer

    def largest(self, base, geo, fg, skip, points, counts):
        need = self.tracer.largest(base, geo, fg, skip, points, counts)
        start = 0
        for c in counts:
            if c > 3:
                points[start + 1] += 1
                break
            start += max(int(c), 0)
        return need


@pytest.fixture
def fresh_probe():
    paste.native_contours.cache_clear()
    yield
    paste.native_contours.cache_clear()


def _masks_and_boxes(seed=11, shape=(180, 320)):
    rng = np.random.default_rng(seed)
    n = 30
    boxes = np.stack([rng.uniform(0, shape[1], n), rng.uniform(0, shape[0], n), rng.uniform(8, 90, n),
                      rng.uniform(4, 40, n), rng.uniform(-180, 180, n)], 1).astype(np.float32)
    logits = rng.normal(0, 0.8, (n, 28, 28)) + rng.normal(0, 1.0, (n, 1, 1))
    masks = (1 / (1 + np.exp(-logits))).astype(np.float16)
    return masks, boxes, shape


def _paster_counts(masks, boxes, shape):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.reset()
        got = paste.RotatedMaskPaster("cpu")(masks, boxes, shape)
        counts = trace.totals()
    return got, {k: counts.get(f"glass.post.polygons.{k}", 0) for k in ("native_words", "cv2_words",
                                                                         "device_words", "fallback_words")}


@pytest.mark.parametrize("contours", ["native", "cv2"])
def test_paster_polygons_equal_the_loop(contours, monkeypatch):
    """The paster's whole flow, K3's plain version standing in for the
    card, with the tracer and with cv2; the counters say which traced how
    many words (K3's words and the host's)."""
    if contours == "native" and paste.native_contours() is None:
        pytest.skip("the native contour tracer did not build or is not this cv2's")
    if contours == "cv2":
        monkeypatch.setattr(paste, "native_contours", lambda: None)
    monkeypatch.setattr(paste, "COORD_LIMIT", 60.0)  # some words warped on the host
    masks, boxes, shape = _masks_and_boxes()
    want = paste.rotated_masks_to_polygons(masks, boxes, shape)
    assert sum(p is not None for p in want) > 10
    got, counts = _paster_counts(masks, boxes, shape)
    assert_same(got, want)
    win, _, _ = paste.word_windows(boxes, shape, masks.shape[1:])
    nonempty = int(((win[:, 2] > win[:, 0]) & (win[:, 3] > win[:, 1])).sum())
    assert counts["fallback_words"] > 0 and counts["device_words"] > 0
    assert counts[f"{contours}_words"] == nonempty
    assert counts["cv2_words" if contours == "native" else "native_words"] == 0


@pytest.mark.parametrize("fault", ["no_library", "planted"])
def test_probe_falls_back_to_cv2(fault, fresh_probe, monkeypatch):
    """Without the library, or with a tracer that is off by one point on
    one probe window, the probe admits no tracer and cv2 traces every
    word, with the same polygons."""
    if fault == "no_library":
        monkeypatch.setattr(paste, "load_contours", lambda: None)
    else:
        if load_contours() is None:
            pytest.skip("the native contour tracer did not build")
        monkeypatch.setattr(paste, "load_contours", lambda: Planted(load_contours()))
    assert paste.native_contours() is None
    masks, boxes, shape = _masks_and_boxes(12)
    got, counts = _paster_counts(masks, boxes, shape)
    assert_same(got, paste.rotated_masks_to_polygons(masks, boxes, shape))
    win, _, _ = paste.word_windows(boxes, shape, masks.shape[1:])
    assert counts["cv2_words"] == int(((win[:, 2] > win[:, 0]) & (win[:, 3] > win[:, 1])).sum()) > 0
    assert counts["native_words"] == 0


def test_contours_build_failure_warns_and_gives_none(tmp_path, monkeypatch):
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    warned = []
    monkeypatch.setenv("GLASS_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_contours", None)
    monkeypatch.setattr(build.subprocess, "run", no_compiler)
    monkeypatch.setattr(build.logger, "warning", lambda msg, *a: warned.append(msg % a))
    assert load_contours() is None
    assert len(warned) == 1 and "using cv2" in warned[0]
