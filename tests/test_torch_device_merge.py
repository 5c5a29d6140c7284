"""The port's batched min-area rectangle and on-device merge against
glass_tpu's, on the same seeded inputs.

``min_area_rect`` / ``polygons_to_rotated_boxes``: the port projects every
point onto every pair direction at once where glass_tpu builds a monotone-
chain hull; boxes must agree within 1e-3 px and 1e-3 degrees, on the cases
where the choice of edge is a tie (axis-aligned rectangles, squares), on
collinear and duplicate points, and on random quads.

``merge_intersecting_boxes_device``: equal ``valid`` and boxes within the
same tolerances, on random padded sets whose pairwise IoA keeps 1e-5 away
from the merge gate (a pair at the gate may merge on one side only): each
iteration from glass_tpu's state, and whole fixpoints.  A fixpoint feeds
each iteration's boxes to the next, so the two sides' rounding (sin/cos,
products) compounds, and where the area of the enclosing rectangle barely
changes with its angle (a box merged with a near-copy of itself) an edge
can win on rounding alone; the whole-fixpoint cases are sets where that
stays inside the tolerances.  Then the POST_PROCESSING.ON_DEVICE wiring
through ``build_post_processor``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.ops import min_area_rect as j_min_area_rect
from glass_tpu.ops import polygons_to_rotated_boxes as j_polygons_to_rotated_boxes_eager
from glass_tpu.postprocess import build_post_processor as j_build_post_processor
from glass_tpu.postprocess.device_merge import merge_intersecting_boxes_device as j_merge
from glass_tpu.structures import Instances as JInstances

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.ops.boxes import boxes_to_polygons
from glass_tpu_torch.ops.iou_rotated import pairwise_ioa_rotated
from glass_tpu_torch.ops.min_area_rect import min_area_rect, polygons_to_rotated_boxes
from glass_tpu_torch.postprocess import build_post_processor
from glass_tpu_torch.postprocess.device_merge import merge_intersecting_boxes_device
from glass_tpu_torch.structures import Instances

torch.set_num_threads(2)
j_polygons_to_rotated_boxes = jax.jit(j_polygons_to_rotated_boxes_eager)
PX_TOL = 1e-3
DEG_TOL = 1e-3


def _assert_boxes_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=PX_TOL, rtol=0)
    ang = np.abs((got[..., 4] - want[..., 4] + 180.0) % 360.0 - 180.0)
    assert ang.max(initial=0.0) <= DEG_TOL, ang.max()


def _quads(boxes):
    return boxes_to_polygons(torch.from_numpy(np.asarray(boxes, np.float32))).numpy()


def _union_sets(rng, n):
    """(n, 8, 2) unions of two word quads, as the merge fits them."""
    a = np.stack([rng.uniform(50, 900, n), rng.uniform(50, 700, n), rng.uniform(20, 200, n),
                  rng.uniform(8, 40, n), rng.uniform(-90, 90, n)], 1)
    b = a + np.stack([rng.uniform(-30, 30, n), rng.uniform(-5, 5, n), rng.uniform(-10, 10, n),
                      rng.uniform(-3, 3, n), rng.uniform(-5, 5, n)], 1)
    return np.concatenate([_quads(a), _quads(b)], 1).astype(np.float32)


def _special_sets():
    """Sets where several edges tie, or the hull is degenerate."""
    sets = []
    axis = lambda x0, y0, x1, y1: [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]  # noqa: E731
    sets.append(axis(10, 20, 70, 35) + axis(50, 18, 110, 37))       # two axis-aligned words
    sets.append(axis(10, 20, 70, 35) + axis(10, 20, 70, 35))        # duplicate quads
    sets.append(axis(0, 0, 40, 40) + axis(10, 10, 30, 30))          # a square around a square
    sets.append(axis(100, 100, 140, 140) + axis(120, 100, 160, 140))  # squares side by side
    sets.append([[5 * k, 2 * k + 3] for k in range(8)])             # collinear points
    sets.append([[7, 9]] * 8)                                       # one point eight times
    sets.append([[3, 4]] * 4 + [[30, 4]] * 4)                       # two points
    sets.append(axis(0, 0, 50, 10) + [[25, 0], [50, 5], [25, 10], [0, 5]])  # edge midpoints
    poly = _quads(np.array([[200, 150, 80, 20, 30], [230, 170, 80, 20, 30]], np.float32))
    sets.append(list(poly.reshape(-1, 2)))                          # same angle, shifted
    return np.asarray(sets, np.float32)


def _jax_rects(points):
    return np.stack([np.asarray(v) for v in jax.jit(jax.vmap(j_min_area_rect))(jnp.asarray(points))], 1)


@pytest.mark.parametrize("kind", ["special", "random"])
def test_min_area_rect_matches_glass_tpu(kind):
    pts = _special_sets() if kind == "special" else _union_sets(np.random.RandomState(0), 24)
    want = _jax_rects(pts)
    got = np.stack([t.numpy() for t in min_area_rect(torch.from_numpy(pts))], 1)
    # the same rectangle: centre, area and the (w, h) pair up to the edge choice
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=PX_TOL, rtol=0)
    np.testing.assert_allclose(np.sort(got[:, 2:4], 1), np.sort(want[:, 2:4], 1), atol=PX_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["special", "random"])
def test_polygons_to_rotated_boxes_matches_glass_tpu(kind):
    rng = np.random.RandomState(1)
    pts = _special_sets() if kind == "special" else _union_sets(rng, 32)
    # small radians-as-degrees orientations (the merge's quirk), whole
    # quadrants, and angles one degree off the rule's 45-degree boundaries
    orients = np.concatenate([rng.uniform(-3.2, 3.2, len(pts) // 2),
                              rng.choice([-179.0, -136.0, -90.0, -44.0, 0.0, 46.0, 90.0, 134.0],
                                         len(pts) - len(pts) // 2)]).astype(np.float32)
    want = np.asarray(j_polygons_to_rotated_boxes(jnp.asarray(pts), jnp.asarray(orients)))
    got = polygons_to_rotated_boxes(torch.from_numpy(pts), torch.from_numpy(orients)).numpy()
    _assert_boxes_close(got, want)


def test_polygons_to_rotated_boxes_point_masks():
    """Masked points are left out.  glass_tpu's own masked hull is not the
    yardstick here: its upper chain walks the reversed sort, which starts
    with the masked points (``glass_tpu/ops/min_area_rect.py:75``), a path
    its merge never takes (no mask).  So each masked set is held against
    glass_tpu on its valid points alone, and against ``cv2.minAreaRect``."""
    import cv2

    pts = _union_sets(np.random.RandomState(2), 12)
    valid = np.ones(pts.shape[:2], bool)
    valid[::2, 4:] = False        # half of the sets are one quad plus padding
    valid[1::4, 5] = False
    orients = np.zeros(len(pts), np.float32)
    got = polygons_to_rotated_boxes(torch.from_numpy(pts), torch.from_numpy(orients),
                                    torch.from_numpy(valid)).numpy()
    for count in np.unique(valid.sum(1)):
        rows = valid.sum(1) == count
        compact = np.stack([p[v] for p, v in zip(pts[rows], valid[rows])])
        want = np.asarray(j_polygons_to_rotated_boxes(jnp.asarray(compact), jnp.asarray(orients[rows])))
        _assert_boxes_close(got[rows], want)
    for g, p, v in zip(got, pts, valid):
        (cx, cy), (w, h), _ = cv2.minAreaRect(p[v])
        np.testing.assert_allclose(g[:2], [cx, cy], atol=1e-2)
        np.testing.assert_allclose(sorted(g[2:4]), sorted([w, h]), atol=1e-2)


def _word_set(rng, cap, n):
    """A padded set of n word boxes along text lines, many overlapping."""
    boxes = np.zeros((cap, 5), np.float32)
    boxes[:, 2:4] = 1.0
    lines = rng.randint(0, 4, n)
    boxes[:n, 0] = rng.uniform(40, 40 + 12 * n, n)
    boxes[:n, 1] = 60 + 40 * lines + rng.uniform(-3, 3, n)
    boxes[:n, 2] = rng.uniform(30, 90, n)
    boxes[:n, 3] = rng.uniform(10, 22, n)
    boxes[:n, 4] = rng.choice([0.0, 2.0, -3.0], n) + rng.uniform(-4, 4, n)
    scores = np.zeros(cap, np.float32)
    scores[:n] = rng.uniform(0.05, 1.0, n)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return boxes, scores, valid


def _near_gate(boxes, valid, gate=0.3, margin=1e-5):
    ioa = pairwise_ioa_rotated(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    both = valid[:, None] & valid[None, :] & ~np.eye(len(boxes), dtype=bool)
    return bool((np.abs(ioa - gate)[both] < margin).any())


@pytest.mark.parametrize("seed", range(6))
def test_merge_matches_glass_tpu(seed):
    rng = np.random.RandomState(seed)
    cap = [8, 16, 32, 64, 128, 16][seed]
    while True:
        boxes, scores, valid = _word_set(rng, cap, rng.randint(cap // 2, cap + 1))
        if not _near_gate(boxes, valid):
            break
    jb, jv = j_merge(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    tb, tv = merge_intersecting_boxes_device(torch.from_numpy(boxes), torch.from_numpy(scores),
                                             torch.from_numpy(valid))
    jv, tv = np.asarray(jv), tv.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() < valid.sum(), "no pair merged: the case tests nothing"
    _assert_boxes_close(tb.numpy()[tv], np.asarray(jb)[jv])


@pytest.mark.parametrize("seed", range(100, 112))
def test_merge_iterations_match_glass_tpu(seed):
    """Each iteration of the fixpoint from glass_tpu's state of the one
    before (``max_iters=1`` on both sides), so that rounding differences do
    not compound over iterations: the same survivors and boxes within the
    tolerances at every step, until glass_tpu's set stops changing."""
    rng = np.random.RandomState(seed)
    cap = [16, 32, 64, 128][seed % 4]
    while True:
        boxes, scores, valid = _word_set(rng, cap, rng.randint(cap // 2, cap + 1))
        if not _near_gate(boxes, valid):
            break
    merged = 0
    for _ in range(8):
        jb, jv = (np.array(t) for t in j_merge(jnp.asarray(boxes), jnp.asarray(scores),
                                                  jnp.asarray(valid), max_iters=1))
        tb, tv = merge_intersecting_boxes_device(torch.from_numpy(boxes), torch.from_numpy(scores),
                                                 torch.from_numpy(valid), max_iters=1)
        np.testing.assert_array_equal(tv.numpy(), jv)
        _assert_boxes_close(tb.numpy()[jv], jb[jv])
        if np.array_equal(jb, boxes) and np.array_equal(jv, valid):
            break
        merged += int(valid.sum() - jv.sum())
        boxes, valid = jb, jv
    assert merged > 0, "no pair merged: the case tests nothing"


def test_merge_respects_gates_and_padding():
    """Overlapping boxes of very different heights do not merge; padded
    rows stay out; an empty set is unchanged."""
    boxes = np.zeros((8, 5), np.float32)
    boxes[:, 2:4] = 1.0
    boxes[0] = [50, 50, 30, 10, 0]
    boxes[1] = [52, 50, 30, 40, 0]
    boxes[2] = [52, 50, 30, 10, 0]   # padding on top of box 0
    scores = np.array([0.9, 0.8, 0.9, 0, 0, 0, 0, 0], np.float32)
    valid = np.array([True, True] + [False] * 6)
    tb, tv = merge_intersecting_boxes_device(torch.from_numpy(boxes), torch.from_numpy(scores),
                                             torch.from_numpy(valid))
    np.testing.assert_array_equal(tv.numpy(), valid)
    np.testing.assert_allclose(tb.numpy()[:2], boxes[:2], atol=1e-4)
    tb, tv = merge_intersecting_boxes_device(torch.from_numpy(boxes), torch.from_numpy(scores),
                                             torch.zeros(8, dtype=torch.bool))
    assert not tv.any()


@pytest.mark.parametrize("n", [1, 9, 40])
def test_on_device_wiring_matches_glass_tpu(n):
    """POST_PROCESSING.ON_DEVICE through build_post_processor
    (PostProcessorRotatedBoxes): padded to a power-of-two capacity of at
    least 8, descending-score output, on the CPU here."""
    rng = np.random.RandomState(10 + n)
    while True:
        boxes, scores, valid = _word_set(rng, n, n)
        if not _near_gate(boxes, valid):
            break
    opts = ["POST_PROCESSING.NAME", "PostProcessorRotatedBoxes", "POST_PROCESSING.ON_DEVICE", "True"]
    jpp = j_build_post_processor(j_get_cfg(None, opts))
    pp = build_post_processor(get_cfg(None, opts), device="cpu")
    assert pp.on_device and pp.device == torch.device("cpu")
    want = jpp(JInstances((480, 640), pred_boxes=boxes.copy(), scores=scores.copy()))
    got = pp(Instances((480, 640), pred_boxes=boxes.copy(), scores=scores.copy()))
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(np.asarray(got.scores), np.asarray(want.scores))
    _assert_boxes_close(got.pred_boxes, want.pred_boxes)
    np.testing.assert_allclose(np.asarray(got.pred_polygons), np.asarray(want.pred_polygons), atol=2e-3)


def test_on_device_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg(None, ["POST_PROCESSING.ON_DEVICE", "True"])
    with pytest.raises(RuntimeError, match="is_available"):
        build_post_processor(cfg)
    assert build_post_processor(get_cfg()).device is None  # the host merge needs no device
