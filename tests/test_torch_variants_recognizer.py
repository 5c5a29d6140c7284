"""Serving with the other recognizer CNNs and the CTC head: the port against
glass_tpu.

As tests/test_torch_variants.py: the ICDAR15 config with tools/eval_glass.py's
protocol overrides, cut to a 128 x 160 bucket, 8 detections and words of up
to 5 characters in f32; ``glass_inference_single`` on the same seeded
weights and image against glass_tpu's, every output field.

The parameter trees.  glass_tpu builds CNN_V1_1's recognizer tree for every
``RECOGNIZER_HEAD.BACKBONE`` name; the port builds the same shapes, so
glass_tpu's tree here is the port's ``state_dict`` converted by glass_tpu's
own reader: CNN_V1_RECT runs its (2, 1) ``conv1`` at stride 1 (height 7),
CNN_V2 carries a ``conv3`` (in glass_tpu only a checkpoint supplies one;
here both sides get the port's seeded one), and Identity has no backbone
tensors (glass_tpu's ignores its tree).

CTC (``DECODER.NAME`` CTC with ``LABELS_TYPE`` ctc, a 96-symbol vocabulary
with the blank at 0): the text is the per-step softmax of the encoder's 32
steps, (D, 32, V).  Its steps are independent (no greedy feedback), so a
step whose reference top-two margin is under 1e-4 (a knife edge of a random
model's flat distributions, tests/test_torch_slice.py) is left out of the
id comparison alone; the step scores are compared on every step at 1e-3.
``GlassRunner.__call__`` decodes the texts through the codec's
``_decode_ctc`` on both sides, two-stage serving scatters the (cap, 32)
text fields back into the D rows, and ``TPU.TEXT_EMIT`` probs (the full
distributions fetched) decodes to the texts of the default topk fetch.
"""

import os
import sys

import numpy as np
import pytest
import torch

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_configs_totaltext import ROOT, check_inference_single, check_runner_call  # noqa: E402
from test_torch_slice import KNIFE_EDGE, EVAL_OPTS, TINY_OPTS, synthetic_image  # noqa: E402
from test_torch_variants import every_step  # noqa: E402

torch.set_num_threads(2)
ICDAR15 = os.path.join(ROOT, "configs", "glass_finetune_icdar15.yaml")
BACKBONE = "MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.BACKBONE.NAME"
CTC = ["MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.DECODER.NAME", "CTC",
       "MODEL.ROI_RECOGNIZER_HEAD.LABELS_TYPE", "ctc"]


@pytest.mark.parametrize("name,height", [("CNN_V1_RECT", 7), ("CNN_V2", 4), ("Identity", 8)])
def test_recognizer_backbone_serving_matches_glass_tpu(name, height):
    port, _ = check_inference_single(ICDAR15, "float32", opts=[BACKBONE, name], compare=every_step)
    with torch.no_grad():
        out = port.roi_heads.recognizer_head.backbone(torch.zeros(1, 256, 8, 32))
    assert out.shape[2] == height


def ctc_steps(got, want):
    """Every field as ``every_step``, the text ids on every step that is
    not a knife edge."""
    probs = want["text_probs"]
    assert probs.shape == (8, 32, 96) and got["text_ids"].shape == (8, 32)
    top2 = np.sort(probs, -1)[..., -2:]
    steps = (top2[..., 1] - top2[..., 0]) >= KNIFE_EDGE
    assert steps.mean() > 0.95, f"{(~steps).sum()} knife-edge steps"
    np.testing.assert_array_equal(got["text_ids"][steps], probs.argmax(-1)[steps])
    np.testing.assert_allclose(got["text_step_scores"], probs.max(-1), atol=1e-3)
    ids = np.where(steps, probs.argmax(-1), got["text_ids"])
    every_step(dict(got, text_ids=ids), want)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_ctc_serving_matches_glass_tpu(dtype):
    port, _ = check_inference_single(ICDAR15, dtype, opts=CTC, compare=ctc_steps)
    assert port.roi_heads.recognizer_head.ctc and port.arch.vocab_size == 96


def test_ctc_runner_call_decodes_as_glass_tpu():
    """``__call__`` with CTC: post-processing and the codec's CTC decoding
    (repeats collapsed, blanks dropped) give glass_tpu's texts."""
    got, texts = check_runner_call(ICDAR15, opts=CTC)
    assert len(texts) == len(got) > 0 and any(texts)


def test_ctc_two_stage_scatters_the_ctc_steps_back():
    """Two-stage serving runs the CTC head on the word bucket and scatters
    its (cap, 32) text fields back into the D detection rows, equal to
    one-stage serving."""
    opts = EVAL_OPTS + TINY_OPTS + CTC + ["TPU.WORD_BUCKETS", "[2, 4]"]
    sd = GlassRunner(cfg=get_cfg(ICDAR15, opts), device="cpu").model.state_dict()
    image = synthetic_image(3, 100, 140)
    one = GlassRunner(cfg=get_cfg(ICDAR15, opts), state_dict=sd, device="cpu").run_model(image)
    two = GlassRunner(cfg=get_cfg(ICDAR15, opts + ["TPU.TWO_STAGE_INFERENCE", "True"]), state_dict=sd,
                      device="cpu").run_model(image)
    assert one["text_ids"].shape == two["text_ids"].shape == (8, 32)
    valid = one["valid"]
    np.testing.assert_array_equal(two["valid"], valid)
    np.testing.assert_array_equal(two["text_ids"][valid], one["text_ids"][valid])
    np.testing.assert_allclose(two["text_step_scores"][valid], one["text_step_scores"][valid], atol=1e-5)
    assert not two["text_step_scores"][~valid].any()


def test_ctc_text_emit_probs_decodes_as_topk():
    """TPU.TEXT_EMIT probs fetches the (D, 32, V) CTC distributions; the
    codec's CTC decoding of them gives the texts of the default "topk"
    fetch (per-step argmax ids and max probabilities)."""
    opts = EVAL_OPTS + TINY_OPTS + CTC
    sd = GlassRunner(cfg=get_cfg(ICDAR15, opts), device="cpu").model.state_dict()
    image = synthetic_image(4, 100, 140)
    topk = GlassRunner(cfg=get_cfg(ICDAR15, opts), state_dict=sd, device="cpu")
    probs = GlassRunner(cfg=get_cfg(ICDAR15, opts + ["TPU.TEXT_EMIT", "probs"]), state_dict=sd, device="cpu")
    assert probs.run_model(image)["text_probs"].shape == (8, 32, 96)
    a, b = topk(image), probs(image)
    assert len(a) == len(b) > 0
    assert topk.decode_texts(a)[0] == probs.decode_texts(b)[0]
    np.testing.assert_allclose(topk.decode_texts(a)[1], probs.decode_texts(b)[1], rtol=1e-6)
