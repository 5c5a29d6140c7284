"""Batched serving of the port: ``eval_batch_call`` and ``batch_call``.

Against the port's own b = 1 serving, bit for bit, with TPU.ASYNC_FETCH on
and off and TPU.POSTPROCESS_WORKERS 0 and 2 (``SERVE_BATCH_MODE="map"``
runs the single-image program over the batch's rows; "vmap", one program
over the batch, is held to map at the glass_tpu tolerances); then against
glass_tpu's ``eval_batch_call`` on the same random model at the slice's
tolerances (tests/test_torch_slice.py): boxes 0.05 px + 1e-4 relative,
scores 1e-3, text ids equal before a knife-edge decoding step.  The ICDAR15
eval configuration cut to a 128 x 160 bucket, with loosened post-processing
thresholds so that a random model's words survive.
"""

import os

import jax
import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.inference import GlassRunner as JRunner
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner
from glass_tpu_torch.inference.runner import calibrate_batch_norm_, random_init_
from glass_tpu_torch.models import GlassArch, GlassRCNN

torch.set_num_threads(2)
ICDAR15 = os.path.join(os.path.dirname(__file__), "..", "configs", "glass_finetune_icdar15.yaml")
EVAL_OPTS = [
    "MODEL.ROI_HEADS.NMS_THRESH_TEST", "0.35", "INFERENCE_TH_TEST", "0.3",
    "POST_PROCESSING.TEXT_THRESHOLD", "0.3", "POST_PROCESSING.DETECT_THRESHOLD", "0.65",
    "INPUT.MIN_SIZE_TEST", "1000", "INPUT.MAX_SIZE_TEST", "1600",
    "MODEL.ROI_MASK_HEAD.MASK_INFERENCE", "True", "MODEL.ROI_ORIENTATION_HEAD.APPLY_TO_BOXES", "False",
]
TINY_OPTS = [
    "INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "160", "TPU.IMAGE_BUCKETS", "[[128, 160]]",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
    "TEST.DETECTIONS_PER_IMAGE", "8", "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "5",
    "TPU.COMPUTE_DTYPE", "float32", "POST_PROCESSING.VALID_CONFIDENCE", "0.05",
    "POST_PROCESSING.DETECT_THRESHOLD", "0.1", "POST_PROCESSING.TEXT_THRESHOLD", "0.0",
]
KNIFE_EDGE = 1e-4


def images(seed, n, hw=(100, 140)):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = (rng.rand(*hw, 3) * 60 + 100).astype(np.uint8)
        for _ in range(6):
            y, x = rng.randint(0, hw[0] - 16), rng.randint(0, hw[1] - 40)
            img[y:y + 12, x:x + 34] = rng.randint(0, 256, 3)
        out.append(img)
    return out


@pytest.fixture(scope="module")
def model():
    """Seeded random weights, BN statistics calibrated on one padded image."""
    cfg = get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS)
    pad = np.zeros((128, 160, 3), np.float32)
    pad[:114, :160] = images(0, 1, (114, 160))[0]
    m = random_init_(GlassRCNN(GlassArch.from_config(cfg)), seed=0).eval()
    calibrate_batch_norm_(m, torch.from_numpy(pad), (114, 160))
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


def _runner(state, *opts, post_process=True):
    cfg = get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS + list(opts))
    return GlassRunner(cfg=cfg, state_dict=state, device="cpu", post_process=post_process)


def _assert_same(a, b):
    """Two post-processed prediction lists, bit for bit."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.image_size == y.image_size and sorted(x.get_fields()) == sorted(y.get_fields())
        for k, v in x.get_fields().items():
            w = y.get(k)
            if isinstance(v, list):
                assert len(v) == len(w) and all(np.array_equal(p, q) for p, q in zip(v, w)), k
            else:
                np.testing.assert_array_equal(np.asarray(v), np.asarray(w), err_msg=k)


@pytest.fixture(scope="module")
def b1(model):
    """Five images served one at a time."""
    imgs = images(1, 5)
    return imgs, _runner(model).eval_batch_call(imgs, batch_size=1)


@pytest.mark.parametrize("async_fetch,workers", [(True, 0), (False, 0), (True, 2)])
def test_eval_batch_call_equals_b1(model, b1, async_fetch, workers):
    """Batches of 4 then 1: a pipeline of two batches."""
    imgs, want = b1
    runner = _runner(model, "TPU.ASYNC_FETCH", str(async_fetch), "TPU.POSTPROCESS_WORKERS", str(workers))
    got = runner.eval_batch_call(imgs, batch_size=4)
    assert sum(len(p) for p in got) > 0, "no word survived: the case tests nothing"
    _assert_same(got, want)
    assert all(p.has("pred_mask_polygons") and p.has("pred_text_ids") for p in got)


def test_batch_call_equals_single_calls(model):
    """batch_call (the demo scale rule) against __call__ image by image;
    images of two sizes, both in the one bucket."""
    imgs = images(2, 2, (110, 150)) + images(3, 1, (96, 120))
    runner = _runner(model)
    _assert_same(runner.batch_call(imgs, batch_size=3), [runner(im) for im in imgs])


def test_raw_batch_outputs_equal_b1(model):
    """Without post-processing: every fetched field of every row."""
    runner = _runner(model, post_process=False)
    imgs = [im.astype(np.float32) for im in images(4, 2, (114, 160))]
    batched = runner.run_batch_on_resized(imgs)
    _assert_same(batched, [runner.run_batch_on_resized([im])[0] for im in imgs])
    _assert_same(batched, [runner.run_on_resized(im) for im in imgs])


def test_unported_batch_modes_raise(model):
    """Every batch mode runs (the name is kept from when "vmap" raised).
    "vmap", and as in glass_tpu any mode other than "map", serves
    eval_batch_call through the one batched program and equals map's
    predictions at this file's glass_tpu tolerances (text ids before a
    knife-edge step of map's character distributions).
    TPU.TWO_STAGE_INFERENCE is ported: batched serving stays one-stage under
    it (glass_tpu's batched program ignores the flag), so its
    eval_batch_call equals the one-stage runner's bit for bit."""
    imgs = images(5, 2)
    want = _runner(model, "TPU.TEXT_EMIT", "probs").eval_batch_call(imgs, batch_size=2)
    assert sum(len(p) for p in want) > 0
    for mode in ("vmap", "batched"):
        runner = _runner(model, "TPU.TEXT_EMIT", "probs", "TPU.SERVE_BATCH_MODE", mode)
        _assert_close(runner.eval_batch_call(imgs, batch_size=2), want)
    two_stage = _runner(model, "TPU.TWO_STAGE_INFERENCE", "True")
    _assert_same(two_stage.eval_batch_call(imgs, batch_size=2),
                 _runner(model).eval_batch_call(imgs, batch_size=2))


def _steps_before_knife_edge(want_probs):
    top2 = np.sort(want_probs, axis=-1)[..., -2:]
    edge = (top2[..., 1] - top2[..., 0]) < KNIFE_EDGE
    assert edge.sum() <= 1, f"{edge.sum()} knife-edge decoding steps"
    return ~np.cumsum(edge, axis=1).astype(bool)


def test_eval_batch_call_matches_glass_tpu(model):
    """glass_tpu's eval_batch_call (lax.map batches, async fetch) on the same
    weights; the full character distributions are fetched on both sides
    (TPU.TEXT_EMIT probs) to find knife-edge steps."""
    opts = EVAL_OPTS + TINY_OPTS + ["TPU.TEXT_EMIT", "probs"]
    params = _walk_rename(convert_torch_state_dict({k: v.numpy() for k, v in model.items()}))
    jrunner = JRunner(None, cfg=j_get_cfg(ICDAR15, opts), params=jax.tree_util.tree_map(np.asarray, params))
    runner = _runner(model, "TPU.TEXT_EMIT", "probs")
    imgs = images(6, 4)
    want = jrunner.eval_batch_call(imgs, batch_size=2)
    got = runner.eval_batch_call(imgs, batch_size=2)
    assert sum(len(p) for p in want) > 0
    _assert_close(got, want)


def _assert_close(got, want):
    """Post-processed predictions with the character distributions, at the
    slice's tolerances."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) and g.image_size == w.image_size
        if not len(w):
            continue
        np.testing.assert_allclose(np.asarray(g.pred_boxes), np.asarray(w.pred_boxes), atol=0.05, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(g.scores), np.asarray(w.scores), atol=1e-3)
        wp, gp = np.asarray(w.pred_text_prob), np.asarray(g.pred_text_prob)
        steps = _steps_before_knife_edge(wp)
        np.testing.assert_array_equal(gp.argmax(-1)[steps], wp.argmax(-1)[steps])
        np.testing.assert_allclose(gp, wp, atol=2e-3)
        assert len(g.pred_mask_polygons) == len(w.pred_mask_polygons)
