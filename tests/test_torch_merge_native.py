"""The merge fixpoint's rotated IoU: the native clip against the numpy body
it replaces, and one IoU matrix a round.

``pairwise_iou_rotated_np`` takes ``native/polyclip.cpp`` whenever the
library loads; its numpy body (``_pairwise_iou_quads_numpy``) is the path
without it.  The two must give the same bits (the merge's gates are
discrete), compared as int32 views, on random, near-duplicate, zero-area
and far-apart sets and on quads that share an edge, which overflow the
clip's 8 slots and take the scalar clip on both paths.  The fixpoint reuses
NMS's matrix of the merged boxes as the next round's; it must return what
it returns without the library and what glass_tpu's fixpoint, which
computes two fresh matrices a round, returns.
"""

import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.postprocess import build_post_processor as j_build_post_processor
from glass_tpu.structures import Instances as JInstances

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.native import load_polyclip
from glass_tpu_torch.postprocess import build_post_processor
from glass_tpu_torch.postprocess import np_geometry as G
from glass_tpu_torch.structures import Instances
from glass_tpu_torch.utils import trace

torch.set_num_threads(2)
native = pytest.mark.skipif(load_polyclip() is None, reason="the native polygon library did not build")
OPTS = ["POST_PROCESSING.NAME", "PostProcessorRotatedBoxes"]
# The same rectangle as (w, h, a) and (h, w, a + 90): the clip keeps more
# than 8 vertices on the shared edges (tests/test_torch_geometry.py).
COINCIDENT = np.array([[977.80963, 415.10757, 856.4933, 382.90067, -44.504044],
                       [977.80963, 415.10757, 382.90067, 856.4933, 45.495956]], np.float32)


def _random(rng, n, span=200.0):
    return np.stack([rng.uniform(0, span, n), rng.uniform(0, span, n), rng.uniform(1, 80, n),
                     rng.uniform(1, 30, n), rng.uniform(-180, 180, n)], 1).astype(np.float32)


def _case(name, seed):
    rng = np.random.RandomState(seed)
    if name.startswith("random-"):
        return _random(rng, int(name.split("-")[1]))
    if name == "near-duplicates":
        b = _random(rng, 30)
        d = np.repeat(b, 3, 0)
        d += rng.normal(0, 1e-3, d.shape).astype(np.float32) * np.array([1, 1, 1, 1, 10], np.float32)
        return np.concatenate([b, d])
    if name == "zero-area":
        b = _random(rng, 40)
        b[::3, 2] = 0.0
        b[1::5, 3] = 0.0
        b[2::7, 2:4] = 1e-8
        return b
    if name == "far-apart":
        b = _random(rng, 40, span=20.0)
        b[:, :2] += np.arange(40, dtype=np.float32)[:, None] * 1000
        return b
    raise KeyError(name)


def _numpy_iou(b1, b2):
    """The numpy body on the same float64 polygons and areas."""
    p1, p2 = G.boxes_to_polygons_np(b1.astype(np.float64)), G.boxes_to_polygons_np(b2.astype(np.float64))
    a1 = np.asarray(b1[:, 2] * b1[:, 3], np.float64)
    a2 = np.asarray(b2[:, 2] * b2[:, 3], np.float64)
    return G._pairwise_iou_quads_numpy(p1, a1, p2, a2)


def _assert_bits(got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


CASES = ["random-0", "random-1", "random-2", "random-37", "random-100", "near-duplicates", "zero-area",
         "far-apart"]


@native
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_native_iou_equals_the_numpy_body(name, seed):
    b1, b2 = _case(name, seed), _case(name, seed + 50)
    for x, y in ((b1, b1), (b1, b2), (b2, b1)):
        _assert_bits(G.pairwise_iou_rotated_np(x, y), _numpy_iou(x, y))
    if name in ("near-duplicates", "random-100"):
        assert (G.pairwise_iou_rotated_np(b1, b1) > 0).sum() > len(b1), "no pair overlaps: nothing clipped"


@native
@pytest.mark.parametrize("coincident", [COINCIDENT, COINCIDENT[::-1].copy()], ids=["wh-hw", "hw-wh"])
def test_quads_sharing_an_edge_take_the_scalar_clip(coincident):
    b = coincident.astype(np.float64)
    p, a = G.boxes_to_polygons_np(b), np.asarray(coincident[:, 2] * coincident[:, 3], np.float64)
    iou, overflow = load_polyclip().pairwise_iou_quads(p, a, p, a)
    assert len(overflow) and set(overflow.tolist()) <= {1, 2}  # (0, 1) or (1, 0): never the diagonal
    assert (iou.ravel()[overflow] == 0.0).all()  # left for the scalar clip
    got = G.pairwise_iou_rotated_np(coincident, coincident)
    _assert_bits(got, _numpy_iou(coincident, coincident))
    np.testing.assert_allclose(got, np.ones((2, 2)), atol=1e-6)
    mixed = np.concatenate([_random(np.random.RandomState(3), 20, span=1500), coincident])
    _assert_bits(G.pairwise_iou_rotated_np(mixed, mixed), _numpy_iou(mixed, mixed))


def _lines(seed, n_lines=6, per_line=12):
    """Words along text lines, each overlapping the next: the merge joins
    them a pair at a time, over many rounds."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n_lines):
        x0, y0, h = rng.uniform(50, 300), rng.uniform(50, 600), rng.uniform(12, 30)
        ang = rng.uniform(-30, 30)
        t = np.deg2rad(-ang)
        for k in range(per_line):
            d = k * rng.uniform(0.5, 0.9) * h * 1.5
            rows.append([x0 + d * np.cos(t), y0 + d * np.sin(t), h * rng.uniform(1.2, 2.5),
                         h * rng.uniform(0.85, 1.15), ang + rng.uniform(-4, 4)])
    return np.asarray(rows, np.float32), rng.uniform(0.05, 1, len(rows)).astype(np.float32)


def _merge_sets():
    sets = {f"lines-{seed}": _lines(seed) for seed in range(4)}
    sets["lines-small"] = _lines(7, n_lines=2, per_line=5)
    b, s = _lines(11)
    sets["one-word"] = (b[:1], s[:1])
    sets["empty"] = (b[:0], s[:0])
    return sets


MERGE_SETS = _merge_sets()


def _fields(inst):
    return {k: np.asarray(v) for k, v in inst.get_fields().items()}


def _merge(pp, boxes, scores):
    n = len(boxes)
    preds = Instances((720, 1280), pred_boxes=boxes.copy(), scores=scores.copy(),
                      tag=np.arange(n, dtype=np.int64), feat=np.arange(3 * n, dtype=np.float32).reshape(n, 3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.reset()
        out = pp.merge_intersecting_boxes(preds, pp.merge_ioa_thresh, pp.pairs_height_ratio_thresh)
        counts = trace.totals()
    return _fields(out), counts


@pytest.mark.parametrize("name", list(MERGE_SETS))
def test_merge_without_the_library_and_glass_tpus_give_the_same_instances(name, monkeypatch):
    boxes, scores = MERGE_SETS[name]
    pp = build_post_processor(get_cfg(None, OPTS))
    got, counts = _merge(pp, boxes, scores)
    j_got = _fields(j_build_post_processor(j_get_cfg(None, OPTS)).merge_intersecting_boxes(
        JInstances((720, 1280), pred_boxes=boxes.copy(), scores=scores.copy(),
                   tag=np.arange(len(boxes), dtype=np.int64),
                   feat=np.arange(3 * len(boxes), dtype=np.float32).reshape(-1, 3)),
        pp.merge_ioa_thresh, pp.pairs_height_ratio_thresh))
    monkeypatch.setattr(G, "load_polyclip", lambda: None)
    want, _ = _merge(pp, boxes, scores)
    for other in (want, j_got):
        assert list(got) == list(other)
        for k in got:
            assert got[k].dtype == other[k].dtype and got[k].shape == other[k].shape, k
            np.testing.assert_array_equal(got[k].view(np.uint8), other[k].view(np.uint8), err_msg=k)
    if name.startswith("lines-") and name != "lines-small":
        assert counts["glass.post.merge.rounds"] >= 5, "too few rounds to test the reuse"
        assert len(got["tag"]) < len(boxes)


@pytest.mark.parametrize("thresh", [0.99, 0.3, 0.05])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_companion_keeps_the_kept_rows_of_its_matrix(seed, thresh):
    boxes, scores = _lines(seed)
    boxes = np.concatenate([boxes, boxes[::4]])  # exact duplicates, which 0.99 suppresses
    scores = np.concatenate([scores, scores[::4] * 0.5])
    keep, iou = G._nms_rotated_with_iou(boxes, scores, thresh)
    np.testing.assert_array_equal(keep, G.nms_rotated_np(boxes, scores, thresh))
    assert keep.dtype == np.int64 and len(keep) < len(boxes)
    _assert_bits(iou, G.pairwise_iou_rotated_np(boxes[keep], boxes[keep]))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_merge_counters_count_under_a_profiler_only(path, monkeypatch):
    if path == "native" and load_polyclip() is None:
        pytest.skip("the native polygon library did not build")
    if path == "numpy":
        monkeypatch.setattr(G, "load_polyclip", lambda: None)
    pp = build_post_processor(get_cfg(None, OPTS))
    boxes, scores = MERGE_SETS["lines-0"]
    _, counts = _merge(pp, boxes, scores)
    rounds = counts["glass.post.merge.rounds"]
    assert rounds >= 5 and counts["glass.post.merge.matrices"] == rounds  # one matrix a round
    fallback = counts["glass.post.merge.fallback_pairs"]
    assert fallback == 0 if path == "native" else fallback > rounds * len(boxes) // 4
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.reset()
        G.pairwise_iou_rotated_np(COINCIDENT, COINCIDENT)
        n_over = 4 if path == "numpy" else len(load_polyclip().pairwise_iou_quads(
            G.boxes_to_polygons_np(COINCIDENT.astype(np.float64)), np.ones(2),
            G.boxes_to_polygons_np(COINCIDENT.astype(np.float64)), np.ones(2))[1])
        assert trace.totals()["glass.post.merge.fallback_pairs"] == n_over > 0
    trace.reset()
    pp.merge_intersecting_boxes(Instances((720, 1280), pred_boxes=boxes.copy(), scores=scores.copy()),
                                pp.merge_ioa_thresh, pp.pairs_height_ratio_thresh)
    assert trace.totals() == {}


def test_numpy_sums_the_eight_shoelace_terms_pairwise():
    """The native clip sums its 8 terms as numpy's reduction does on this
    host, ((c0+c1)+(c2+c3))+((c4+c5)+(c6+c7)); a float32 IoU hides the
    order's last bit of area, so it is checked on numpy itself."""
    rng = np.random.RandomState(0)
    c = rng.normal(size=(4096, 8)) * rng.uniform(1, 1e4, (4096, 8))
    c[::2, 6:] = 0.0  # slots past the last vertex
    pairwise = ((c[:, 0] + c[:, 1]) + (c[:, 2] + c[:, 3])) + ((c[:, 4] + c[:, 5]) + (c[:, 6] + c[:, 7]))
    np.testing.assert_array_equal(np.where(np.ones_like(c, bool), c, 0.0).sum(axis=1), pairwise)
