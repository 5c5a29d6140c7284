"""The whole slice: glass_tpu_torch against glass_tpu on one random model.

``glass_inference_single`` on the tiny arch of tests/test_model_smoke.py
(f32, mask inference on) on a 128 x 160 image, float and uint8; then
``GlassRunner.__call__`` on the ICDAR15 eval configuration cut to a
128 x 160 bucket, post-processing included.  glass_tpu's side is built
once per module (its jitted forward is the slow part of this file).

The port's weights come through ``glass_tpu_torch.weights`` from the glass_tpu
parameter tree, so this also exercises the weight carry-over.

Tolerances: ``valid`` and the text ids must be equal.  Boxes 0.05 px +
1e-4 rel, scores 1e-4... as tests/test_e2e_mirror_parity.py, except where
stated: both sides are f32 through a random ResNet-50 whose rounding
differences grow with depth, so scores get 1e-3, text step scores and mask
probabilities 2e-3 (masks are fetched in float16, a 2^-11 step).

A random recognizer's character distributions are nearly flat (the top
probability is ~0.04 over 97 classes), so a decoding step can have its two
best characters within f32 noise of each other.  The text ids are equal up
to such a knife edge: a step whose reference top-two margin is under
``KNIFE_EDGE`` (1e-4, three times the largest port-vs-glass_tpu probability
difference seen on agreeing steps, 3e-5) may pick either character, and the
greedy decoder then feeds that choice to the rest of the row, so the row is
compared only before it.  At most one such step is allowed in the output.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.inference import GlassRunner as JRunner
from glass_tpu.models import GlassArch as JArch
from glass_tpu.models import glass_inference_single as j_infer
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner
from glass_tpu_torch.inference.runner import calibrate_batch_norm_, random_init_
from glass_tpu_torch.models import GlassArch, GlassRCNN, glass_inference_single
from glass_tpu_torch.weights import state_dict_from_jax_params

torch.set_num_threads(2)
ARCH_KW = dict(rpn_pre_nms_topk=64, rpn_post_nms_topk=16, detections_per_image=8,
               max_word_len=5, mask_inference=True, compute_dtype="float32")
HW = (120, 150)
KNIFE_EDGE = 1e-4
ICDAR15 = os.path.join(os.path.dirname(__file__), "..", "configs", "glass_finetune_icdar15.yaml")
# tools/eval_glass.py protocol overrides, then a small bucket and loose
# post-processing thresholds so a random model's words survive
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


def synthetic_image(seed, h, w):
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w, 3).astype(np.float32) * 60 + 100
    for _ in range(8):
        y, x = rng.randint(0, h - 18), rng.randint(0, w - 40)
        img[y:y + 14, x:x + 36] = rng.rand(3) * 255
    return img


def random_model(arch, image, hw):
    model = random_init_(GlassRCNN(arch), seed=0).eval()
    calibrate_batch_norm_(model, torch.from_numpy(image), hw)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = _walk_rename(convert_torch_state_dict(sd))
    port = GlassRCNN(arch).eval()
    port.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return port, params


@pytest.fixture(scope="module")
def tiny():
    img = synthetic_image(0, 128, 160)
    port, params = random_model(GlassArch(**ARCH_KW), img, HW)
    jarch = JArch(**ARCH_KW, text_emit="probs")
    fn = jax.jit(lambda p, i, hw: j_infer(jarch, p, i, hw))
    return dict(port=port, params=params, fn=fn, img=img)


def _steps_before_knife_edge(want_probs):
    """(D, T) mask of the decoding steps before each row's first knife edge
    (see the module docstring)."""
    top2 = np.sort(want_probs, axis=-1)[..., -2:]
    edge = (top2[..., 1] - top2[..., 0]) < KNIFE_EDGE
    assert edge.sum() <= 1, f"{edge.sum()} knife-edge decoding steps"
    return ~np.cumsum(edge, axis=1).astype(bool)


def _assert_outputs_match(got, want):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    steps = _steps_before_knife_edge(want["text_probs"])
    np.testing.assert_array_equal(got["text_ids"][steps], want["text_probs"].argmax(-1)[steps])
    np.testing.assert_allclose(got["text_step_scores"][steps], want["text_probs"].max(-1)[steps],
                               atol=2e-3)
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3)
    np.testing.assert_allclose(got["orientations"], want["orientations"], atol=1e-3)
    np.testing.assert_allclose(got["mask_probs"].astype(np.float32),
                               want["mask_probs"].astype(np.float32), atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_glass_inference_single_matches_glass_tpu(tiny, dtype):
    """uint8 under f32 compute takes the raw-image crop with the fold (K2)."""
    img = tiny["img"].astype(dtype)
    want = jax.device_get(tiny["fn"](tiny["params"], jnp.asarray(img), jnp.asarray(HW, jnp.int32)))
    with torch.inference_mode():
        got = glass_inference_single(tiny["port"], torch.from_numpy(img), HW)
    got = {k: v.numpy() for k, v in got.items()}
    assert got["valid"].any()
    assert set(got) - {"text_ids", "text_step_scores"} == set(want) - {"text_probs"}
    _assert_outputs_match(got, {k: np.asarray(v) for k, v in want.items()})


def test_runner_call_matches_glass_tpu():
    """GlassRunner.__call__ on the ICDAR15 eval config: scale rule, bucket
    padding, the model, detector_postprocess, the merge post-processor and
    text decoding."""
    jcfg = j_get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS)
    cfg = get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS)
    image = synthetic_image(1, 100, 140)
    pad = np.zeros((128, 160, 3), np.float32)
    pad[:100, :140] = image
    port, params = random_model(GlassArch.from_config(cfg), pad, (100, 140))
    want = JRunner(None, cfg=jcfg, params=params)(image)
    runner = GlassRunner(cfg=cfg, state_dict=port.state_dict(), device="cpu")
    got = runner(image)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(np.asarray(got.pred_boxes), np.asarray(want.pred_boxes), atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores), atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.pred_polygons), np.asarray(want.pred_polygons), atol=0.05, rtol=1e-4)
    texts, _, _ = runner.decode_texts(got)
    from glass_tpu.text import decode_instance_texts, TextCodec

    want_texts, _, _ = decode_instance_texts(want, TextCodec.from_config(jcfg))
    assert texts == want_texts


def test_runner_eval_call_runs_the_same_model():
    cfg = get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS)
    runner = GlassRunner(cfg=cfg, device="cpu", post_process=False)
    image = (synthetic_image(2, 90, 130)).astype(np.uint8)
    preds = runner.eval_call(image)
    assert preds.image_size == (90, 130)
    assert runner._pick_bucket(100, 140) == (128, 160)
    assert runner.get_inference_scale_ratio((100, 140, 3)) == 1.0
