"""Rotated-box geometry, IoU/IoA and NMS of glass_tpu_torch against glass_tpu
(and the closed-form cases of tests/test_golden_kernel_vectors.py).

Tolerance 1e-4 abs on box arithmetic in pixels of ~100 and on IoU, as
glass_tpu's own parity tests use; keep masks must be equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import glass_tpu.ops.boxes as JB
from glass_tpu.ops.iou_rotated import pairwise_ioa_rotated as j_ioa
from glass_tpu.ops.iou_rotated import pairwise_iou_rotated as j_iou
from glass_tpu.ops.nms_rotated import nms_rotated_mask as j_nms
from glass_tpu.models.rpn import exact_top_k

import glass_tpu_torch.ops.boxes as TB
from glass_tpu_torch.models.rpn import top_k
from glass_tpu_torch.ops.iou_rotated import pairwise_ioa_rotated, pairwise_iou_rotated
from glass_tpu_torch.ops.nms_rotated import nms_rotated_mask

torch.set_num_threads(2)
TOL = 1e-4


def _boxes(rng, n, scale=100.0):
    return np.stack([
        rng.uniform(0, scale, n), rng.uniform(0, scale, n), rng.uniform(2, scale / 2, n),
        rng.uniform(2, scale / 2, n), rng.uniform(-180, 180, n),
    ], axis=1).astype(np.float32)


def test_apply_deltas_and_normalize_angle():
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, 64)
    deltas = (rng.randn(64, 5) * 2).astype(np.float32)
    deltas[:4, 2:4] = 9.0  # beyond the log(1000/16) clamp
    w = (10.0, 10.0, 5.0, 5.0, 10.0)
    want = np.asarray(JB.apply_deltas(jnp.asarray(deltas), jnp.asarray(boxes), w))
    got = TB.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(boxes), w).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=1e-6)
    ang = np.array([-540.0, -180.0, -179.5, 0.0, 179.9, 180.0, 359.0, 725.0], np.float32)
    np.testing.assert_allclose(TB.normalize_angle(torch.from_numpy(ang)).numpy(),
                               np.asarray(JB.normalize_angle(jnp.asarray(ang))), atol=TOL)


def test_clip_and_nonempty():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 64, scale=160.0)
    boxes[:16, 4] = rng.uniform(-1, 1, 16)  # nearly axis-aligned: clipped
    boxes[16:20, 2] = 0.0
    want = np.asarray(JB.clip_rotated_boxes(jnp.asarray(boxes), (120, 150)))
    got = TB.clip_rotated_boxes(torch.from_numpy(boxes), (120, 150))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    np.testing.assert_array_equal(TB.nonempty(got).numpy(), np.asarray(JB.nonempty(jnp.asarray(want))))


def test_overwrite_orientations():
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 64)
    boxes[:8, 4] = [-180, -135, -90, -45, 45, 90, 135, 180]  # round-half ties
    orient = rng.randint(0, 4, 64).astype(np.int32)
    want = np.asarray(JB.overwrite_orientations_on_boxes(jnp.asarray(boxes), jnp.asarray(orient)))
    got = TB.overwrite_orientations_on_boxes(torch.from_numpy(boxes), torch.from_numpy(orient))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_iou_and_ioa_match_glass_tpu():
    rng = np.random.RandomState(3)
    b1, b2 = _boxes(rng, 40), _boxes(rng, 300)  # 300 rows: chunked
    np.testing.assert_allclose(pairwise_iou_rotated(torch.from_numpy(b1), torch.from_numpy(b2)).numpy(),
                               np.asarray(j_iou(jnp.asarray(b1), jnp.asarray(b2))), atol=TOL)
    np.testing.assert_allclose(pairwise_iou_rotated(torch.from_numpy(b2), torch.from_numpy(b1)).numpy(),
                               np.asarray(j_iou(jnp.asarray(b2), jnp.asarray(b1))), atol=TOL)
    np.testing.assert_allclose(pairwise_ioa_rotated(torch.from_numpy(b1), torch.from_numpy(b2)).numpy(),
                               np.asarray(j_ioa(jnp.asarray(b1), jnp.asarray(b2))), atol=TOL)


def test_iou_closed_form_cases():
    """d2's published IoU cases, re-derived in tests/test_golden_kernel_vectors.py."""
    cases = [
        ([0.5, 0.5, 1.0, 1.0, 0.0], [0.25, 0.5, 0.5, 1.0, 0.0], 0.5),
        ([0.5, 0.5, 1.0, 1.0, 45.0], [0.5, 0.5, 1.0, 1.0, 0.0], np.sqrt(2) / 2),
        ([565.0, 565.0, 10.0, 10.0, 0.0], [565.0, 565.0, 10.0, 8.3, 0.0], 0.83),
        ([0.0, 0.0, 4.0, 2.0, 0.0], [0.0, 0.0, 4.0, 2.0, 90.0], 1.0 / 3.0),
        ([0.0, 0.0, 2.0, 2.0, 30.0], [10.0, 10.0, 2.0, 2.0, -60.0], 0.0),
        ([0.0, 0.0, 2.0, 2.0, 45.0], [0.0, 0.0, 4.0, 2.0, 45.0], 0.5),
    ]
    b1 = torch.tensor([c[0] for c in cases])
    b2 = torch.tensor([c[1] for c in cases])
    got = torch.diagonal(pairwise_iou_rotated(b1, b2)).numpy()
    np.testing.assert_allclose(got, [c[2] for c in cases], atol=2e-4)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_keep_mask_matches_glass_tpu(thresh):
    rng = np.random.RandomState(4)
    boxes = _boxes(rng, 150, scale=150.0)
    scores = rng.rand(150).astype(np.float32)
    valid = rng.rand(150) > 0.1
    want = np.asarray(j_nms(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                            valid=jnp.asarray(valid), max_keep=40))
    got = nms_rotated_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thresh,
                           valid=torch.from_numpy(valid), max_keep=40).numpy()
    np.testing.assert_array_equal(got, want)


def test_nms_score_ties_keep_index_order():
    """Equal scores: the lower index ranks first (jnp.argsort is stable), so
    of two identical overlapping boxes the first is kept."""
    rng = np.random.RandomState(5)
    base = _boxes(rng, 30, scale=120.0)
    boxes = np.concatenate([base, base + np.float32(0.5)], 0)
    scores = np.round(rng.rand(60) * 4).astype(np.float32) / 4  # many exact ties
    want = np.asarray(j_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5))
    got = nms_rotated_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5).numpy()
    np.testing.assert_array_equal(got, want)


def test_top_k_tie_order_matches_lax_top_k():
    rng = np.random.RandomState(6)
    x = np.round(rng.randn(5000) * 3).astype(np.float32)  # heavy ties
    jv, ji = exact_top_k(jnp.asarray(x), 300)
    tv, ti = top_k(torch.from_numpy(x), 300)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_host_iou_of_coincident_quads_takes_the_scalar_clip():
    """The same rectangle as (w, h, a) and (h, w, a + 90), met among fp16
    serving outputs on the card: rounding on the shared edges makes the
    vectorized clip keep more vertices than its buffer holds, and
    glass_tpu's host geometry indexes past it; the port's copy sends such
    pairs to the scalar clip, and the rest of the pairs equal glass_tpu's."""
    from glass_tpu.postprocess import np_geometry as JG

    from glass_tpu_torch.postprocess import np_geometry as TG

    same = np.array([[977.80963, 415.10757, 856.4933, 382.90067, -44.504044],
                     [977.80963, 415.10757, 382.90067, 856.4933, 45.495956]], np.float32)
    with pytest.raises(IndexError):
        JG.pairwise_iou_rotated_np(same[:1], same[1:])
    np.testing.assert_allclose(TG.pairwise_iou_rotated_np(same[:1], same[1:]), [[1.0]], atol=1e-6)
    rng = np.random.RandomState(0)
    boxes = np.stack([rng.uniform(0, 60, 24), rng.uniform(0, 60, 24), rng.uniform(4, 40, 24),
                      rng.uniform(4, 20, 24), rng.uniform(-90, 90, 24)], 1).astype(np.float32)
    np.testing.assert_array_equal(TG.pairwise_iou_rotated_np(boxes, boxes), JG.pairwise_iou_rotated_np(boxes, boxes))
