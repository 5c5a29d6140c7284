"""Serving with the model-family variants: the port against glass_tpu.

Each option that changes the serving model is set on the ICDAR15 config
(with tools/eval_glass.py's protocol overrides), cut to the tiny sizes of
tests/test_torch_slice.py (a 128 x 160 bucket, 8 detections, words of up
to 5 characters, f32), and ``glass_inference_single`` is held to glass_tpu's
on the same seeded weights and image, every output field
(tests/test_torch_configs_totaltext.py's ``check_inference_single``):
FeatPadV2 (its widened pool boxes go through K1's plain version, the
crops keep the original boxes, so the uint8 image's raw crop is checked
too), the GC fusion types channel_mul and channel_concat, SimpleAttention,
LocalOnly and Conv1x1.  The recognizer CNNs and the CTC head are in
tests/test_torch_variants_recognizer.py.

Tolerances, those of tests/test_torch_slice.py: valid equal, boxes 0.05 px
+ 1e-4 relative, scores and orientations 1e-3, text step scores and masks
2e-3.  Text ids are equal on every decoding step (``every_step``), which is
stricter than the slice's rule (equal before a knife-edge step, at most
one such step): with LocalOnly, glass_tpu's output on this seed has two
steps whose top-two margin is under 1e-4 (3.3e-5 and 5.8e-5), and the port
picks the same character at both.
"""

import os
import sys

import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.models import GlassArch as JArch

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.models import glass_rcnn as tg

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_configs_totaltext import ROOT, check_inference_single  # noqa: E402

torch.set_num_threads(2)
ICDAR15 = os.path.join(ROOT, "configs", "glass_finetune_icdar15.yaml")
FEATPAD = ["MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.POOLER_PAD.NAME", "FeatPadV2"]
GC = "MODEL.HYBRID_FUSION.FUSION_TYPE"
FUSION = "MODEL.HYBRID_FUSION.NAME"


def every_step(got, want):
    """Every output field against glass_tpu's, the text on every step."""
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["text_ids"], want["text_probs"].argmax(-1))
    np.testing.assert_allclose(got["text_step_scores"], want["text_probs"].max(-1), atol=2e-3)
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3)
    np.testing.assert_allclose(got["orientations"], want["orientations"], atol=1e-3)
    np.testing.assert_allclose(got["mask_probs"].astype(np.float32),
                               want["mask_probs"].astype(np.float32), atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_featpad_v2_serving_matches_glass_tpu(dtype):
    port, out = check_inference_single(ICDAR15, dtype, opts=FEATPAD, compare=every_step)
    assert port.arch.pooler_pad == "FeatPadV2"


def test_featpad_v2_widens_the_pool_boxes_only(monkeypatch):
    """The recognizer's pool takes the widened boxes, the crop the
    detections' own."""
    seen = {}
    pool, crop = tg.roi_align_rotated_adaptive, tg.crop_rois

    def seen_pool(fmap, boxes, *a, **k):
        seen["pool"] = boxes
        return pool(fmap, boxes, *a, **k)

    def seen_crop(image, boxes, *a, **k):
        seen["crop"] = boxes
        return crop(image, boxes, *a, **k)

    monkeypatch.setattr(tg, "roi_align_rotated_adaptive", seen_pool)
    monkeypatch.setattr(tg, "crop_rois", seen_crop)
    model = GlassRCNN(GlassArch.from_config(get_cfg(ICDAR15, FEATPAD + ["TPU.COMPUTE_DTYPE", "float32"]))).eval()
    boxes = torch.tensor([[40.0, 30.0, 12.0, 10.0, 0.0], [60.0, 40.0, 90.0, 10.0, 30.0]])
    feats = {"p2": torch.randn(1, 256, 16, 20), "p3": torch.randn(1, 256, 8, 10)}
    with torch.no_grad():
        tg.recognizer_encode(model, feats, torch.zeros(64, 80, 3), boxes)
    assert torch.equal(seen["crop"], boxes)
    np.testing.assert_allclose(seen["pool"][:, 2].numpy(), [12.0 * 4 / 1.2, 90.0])
    assert torch.equal(seen["pool"][:, [0, 1, 3, 4]], boxes[:, [0, 1, 3, 4]])


@pytest.mark.parametrize("opts", [
    [GC, "channel_mul"], [GC, "channel_concat"], [FUSION, "SimpleAttention"], [FUSION, "LocalOnly"],
    [FUSION, "Conv1x1"],
], ids=["channel_mul", "channel_concat", "SimpleAttention", "LocalOnly", "Conv1x1"])
def test_fusion_serving_matches_glass_tpu(opts):
    port, _ = check_inference_single(ICDAR15, "float32", opts=opts, compare=every_step)
    assert type(port.roi_heads.fusion_net).__name__ == (opts[1] if opts[0] == FUSION else "MultiAspectGCAttention")


def test_resnet_feature_extractor_v2_contract_raises_as_glass_tpu():
    """glass_tpu's shape contract: the V2 extractor's crop/4 map never
    matches the (PH, PW) pool, so both packages refuse it with the
    recognizer on, with the same message."""
    opts = ["MODEL.LOCAL_FEATURE_EXTRACTOR.NAME", "ResNetFeatureExtractorV2"]
    with pytest.raises(ValueError) as want:
        JArch.from_config(j_get_cfg(ICDAR15, opts))
    with pytest.raises(ValueError) as got:
        GlassArch.from_config(get_cfg(ICDAR15, opts))
    assert str(got.value) == str(want.value)
    off = GlassArch.from_config(get_cfg(ICDAR15, opts + ["MODEL.RECOGNIZER_ON", "False"]))
    assert off.local_extractor_name == "ResNetFeatureExtractorV2"
    assert not hasattr(GlassRCNN(off).roi_heads, "hybrid_net")
