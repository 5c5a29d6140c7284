"""Two-stage inference (TPU.TWO_STAGE_INFERENCE) against glass_tpu's two-stage
path and against the port's one-stage path.

The ICDAR15 eval configuration cut to a 128 x 160 bucket, f32,
DETECTIONS_PER_IMAGE 8 and TPU.WORD_BUCKETS [2, 4], so stage 2 runs at 2, 4
or 8 rows; loosened thresholds so a random model's words survive, and a
score threshold of 1 for the case of no detection at all.  The full
character distributions are fetched (TPU.TEXT_EMIT probs) to find
knife-edge decoding steps.

Tolerances, those of tests/test_torch_slice.py: against glass_tpu, valid
equal, boxes 0.05 px + 1e-4 relative, scores and orientations 1e-3, text
probabilities 2e-3 and their argmax equal before a knife-edge step (top-two
margin under 1e-4), mask probabilities 2e-3 (fetched in float16).  Against
the port's one-stage output (the same stage-1 code): valid, boxes, scores
and orientations bit for bit; stage 2 runs on another row count (the valid
rows first, then padding boxes), so its matrix products may round
otherwise: text probabilities within 2e-3 and their argmax equal on every
step up to each row's end-of-word before a knife edge (after it the decoder's
batch-wide stop depends on the other rows), masks within one float16 step
of the fetch (2^-11).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.inference import GlassRunner as JRunner
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner
from glass_tpu_torch.inference import runner as runner_mod
from glass_tpu_torch.inference.runner import calibrate_batch_norm_, random_init_
from glass_tpu_torch.models import GlassArch, GlassRCNN

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_slice import EVAL_OPTS, _steps_before_knife_edge  # noqa: E402
from test_torch_slice import TINY_OPTS as SLICE_TINY_OPTS  # noqa: E402

torch.set_num_threads(2)
ICDAR15 = os.path.join(os.path.dirname(__file__), "..", "configs", "glass_finetune_icdar15.yaml")
TINY_OPTS = SLICE_TINY_OPTS + ["TPU.TEXT_EMIT", "probs", "TPU.WORD_BUCKETS", "[2, 4]"]
TWO = ["TPU.TWO_STAGE_INFERENCE", "True"]
NONE = ["MODEL.ROI_HEADS.SCORE_THRESH_TEST", "1.0"]  # no detection survives
F16_STEP = 2.0 ** -11


def image(seed, hw=(110, 150), n_words=6):
    rng = np.random.RandomState(seed)
    img = rng.rand(*hw, 3).astype(np.float32) * 60 + 100
    for _ in range(n_words):
        y, x = rng.randint(0, hw[0] - 18), rng.randint(0, hw[1] - 40)
        img[y:y + 14, x:x + 36] = rng.rand(3) * 255
    return img


@pytest.fixture(scope="module")
def weights():
    cfg = get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS)
    pad = np.zeros((128, 160, 3), np.float32)
    pad[:110, :150] = image(0)
    model = random_init_(GlassRCNN(GlassArch.from_config(cfg)), seed=0).eval()
    calibrate_batch_norm_(model, torch.from_numpy(pad), (110, 150))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = _walk_rename(convert_torch_state_dict({k: v.numpy() for k, v in state.items()}))
    return state, jax.tree_util.tree_map(np.asarray, params)


def port(weights, *opts, post_process=False):
    return GlassRunner(cfg=get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS + list(opts)), state_dict=weights[0],
                       device="cpu", post_process=post_process)


def glass_tpu(weights, *opts, post_process=False):
    return JRunner(None, cfg=j_get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS + list(opts)), params=weights[1],
                   post_process=post_process)


class Caps:
    """Records the row count of every stage-2 call of the port."""

    def __init__(self, monkeypatch):
        self.seen, fn = [], runner_mod.glass_heads_stage

        def recorded(model, feats, norm, pyr, boxes, *a, **k):
            self.seen.append(int(boxes.shape[0]))
            return fn(model, feats, norm, pyr, boxes, *a, **k)

        monkeypatch.setattr(runner_mod, "glass_heads_stage", recorded)


# (image seed, opts, dtype, stage-2 rows): detection counts that cover the
# buckets, from n = 0 (score threshold 1) through n = 2 and 3 (score
# threshold 0.7) to counts above the largest word bucket (4), which take
# D = 8 rows; the uint8 image goes to stage 2 raw (f32 compute)
MID = ["MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.7"]
CASES = {"none": (1, NONE, np.float32, 2), "few": (3, MID, np.float32, 2), "mid": (1, MID, np.float32, 4),
         "many": (1, (), np.float32, 8), "many_uint8": (2, (), np.uint8, 8)}


def _assert_instances_close(got, want):
    assert len(got) == len(want) and got.image_size == want.image_size
    if not len(want):
        return
    np.testing.assert_allclose(np.asarray(got.pred_boxes), np.asarray(want.pred_boxes), atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores), atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.orientations), np.asarray(want.orientations), atol=1e-3)
    gp, wp = np.asarray(got.pred_text_prob), np.asarray(want.pred_text_prob)
    steps = _steps_before_knife_edge(wp)
    np.testing.assert_array_equal(gp.argmax(-1)[steps], wp.argmax(-1)[steps])
    np.testing.assert_allclose(gp, wp, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got.pred_masks, np.float32), np.asarray(want.pred_masks, np.float32),
                               atol=2e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_stage_matches_glass_tpu(weights, case, monkeypatch):
    seed, opts, dtype, cap = CASES[case]
    img = image(seed).astype(dtype)
    caps = Caps(monkeypatch)
    got = port(weights, *TWO, *opts).run_on_resized(img)
    want = glass_tpu(weights, *TWO, *opts).run_on_resized(img)
    _assert_instances_close(got, want)
    n = len(want)
    assert caps.seen == [next(b for b in (2, 4, 8) if b >= n)] == [cap], (n, caps.seen)
    assert (n == 0) == (case == "none")


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_stage_matches_one_stage(weights, case):
    seed, opts, dtype, _ = CASES[case]
    img = image(seed).astype(dtype)
    one = port(weights, *opts).run_model(img)
    two = port(weights, *TWO, *opts).run_model(img)
    assert sorted(one) == sorted(two)
    for k in ("valid", "boxes", "scores", "classes", "orientations"):
        np.testing.assert_array_equal(two[k], one[k], err_msg=k)
    valid = one["valid"]
    # the rows stage 2 did not run are zero
    for k in ("text_probs", "mask_probs"):
        assert not two[k][~valid].any(), k
    gp, wp = two["text_probs"][valid], one["text_probs"][valid]
    ids = wp.argmax(-1)
    upto_eos = np.cumsum(ids == 0, axis=1) - (ids == 0) == 0  # steps up to the first end-of-word
    steps = _steps_before_knife_edge(wp) & upto_eos
    np.testing.assert_array_equal(gp.argmax(-1)[steps], ids[steps])
    np.testing.assert_allclose(gp[steps], wp[steps], atol=2e-3)
    np.testing.assert_allclose(two["mask_probs"][valid].astype(np.float32),
                               one["mask_probs"][valid].astype(np.float32), atol=F16_STEP)


def test_runner_call_two_stage_matches_glass_tpu(weights):
    """``__call__`` (scale rule, post-processing, text decoding) in two
    stages on both sides."""
    img = image(4, (100, 140))
    got = port(weights, *TWO, post_process=True)(img)
    want = glass_tpu(weights, *TWO, post_process=True)(img)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(np.asarray(got.pred_boxes), np.asarray(want.pred_boxes), atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores), atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.pred_polygons), np.asarray(want.pred_polygons),
                               atol=0.05, rtol=1e-4)
