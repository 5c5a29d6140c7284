"""Stage-by-stage parity of glass_tpu_torch's model against glass_tpu.

One random model (seeded init, BN statistics calibrated on a synthetic
image so activations stay of order one) is converted to glass_tpu's
parameter tree by glass_tpu's own checkpoint converter; each stage then
gets the same numpy inputs on both sides, in f32.

Tolerances: 1e-4 abs where a stage is a few layers deep, as glass_tpu's
parity tests use.  Deep stages carry the f32 rounding of two convolution
libraries through many layers of a random network, where it grows: the
backbone/FPN and the local CNN use glass_tpu's backbone parity bound
(2e-3 abs, tests/test_backbone_parity.py), decoded boxes 1e-3 abs plus
1e-5 rel (image-scale coordinates through exp), text probabilities 2e-3
(tests/test_e2e_mirror_parity.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.models import GlassArch as JArch
from glass_tpu.models import glass_rcnn as jg
from glass_tpu.models.box_head import box_head_apply, box_predictor_apply
from glass_tpu.models.context import Ctx
from glass_tpu.models.fusion import apply_fusion, p2p3_fusion_apply
from glass_tpu.models.local_extractor import local_extractor_forward
from glass_tpu.models.mask_head import mask_head_apply, mask_inference_probs as j_mask_probs
from glass_tpu.models.recognizer import aster_decode_greedy as j_decode
from glass_tpu.models.recognizer import recognizer_layers_apply
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict

from glass_tpu_torch.inference.runner import calibrate_batch_norm_, random_init_
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.models import glass_rcnn as tg
from glass_tpu_torch.models.mask_head import mask_inference_probs
from glass_tpu_torch.models.recognizer import aster_decode_greedy
from glass_tpu_torch.ops.roi_align_rotated import pack_pyramid

torch.set_num_threads(2)
CTX = Ctx(train=False)
ARCH_KW = dict(rpn_pre_nms_topk=64, rpn_post_nms_topk=16, detections_per_image=8,
               max_word_len=5, mask_inference=True, compute_dtype="float32")
HW = (120, 150)


def synthetic_image(seed=0, h=128, w=160):
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w, 3).astype(np.float32) * 60 + 100
    for _ in range(8):
        y, x = rng.randint(0, h - 18), rng.randint(0, w - 40)
        img[y:y + 14, x:x + 36] = rng.rand(3) * 255
    return img


def jax_params(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return _walk_rename(convert_torch_state_dict(sd))


@pytest.fixture(scope="module")
def setup():
    arch = GlassArch(**ARCH_KW)
    model = random_init_(GlassRCNN(arch), seed=0).eval()
    img = synthetic_image()
    calibrate_batch_norm_(model, torch.from_numpy(img), HW)
    params = jax_params(model)
    jarch = JArch(**ARCH_KW)
    norm = jg.preprocess(jarch, jnp.asarray(img))
    feats = jax.device_get(jg.backbone_features(CTX, jarch, params, norm[None]))
    return dict(arch=arch, jarch=jarch, model=model, params=params, img=img,
                norm=np.asarray(norm), feats=feats)


def to_torch_feats(feats):
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v).transpose(0, 3, 1, 2)))
            .contiguous(memory_format=torch.channels_last) for k, v in feats.items()}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_backbone_fpn_matches_glass_tpu(setup):
    with torch.no_grad():
        got = tg.backbone_features(setup["model"], torch.from_numpy(setup["norm"]))
    for k, want in setup["feats"].items():
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=2e-3, err_msg=k)


def test_rpn_proposals_match_glass_tpu(setup):
    jb, js, jv = jg.rpn_proposals_single(CTX, setup["jarch"], setup["params"],
                                         setup["feats"], jnp.asarray(HW, jnp.int32))
    with torch.no_grad():
        tb, ts, tv = tg.rpn_proposals_single(setup["model"], to_torch_feats(setup["feats"]), HW)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    v = np.asarray(jv)
    np.testing.assert_allclose(ts.numpy()[v], np.asarray(js)[v], atol=1e-4)
    np.testing.assert_allclose(tb.numpy()[v], np.asarray(jb)[v], atol=1e-3, rtol=1e-5)


def test_detections_match_glass_tpu(setup):
    det = jg.detect_single_image(CTX, setup["jarch"], setup["params"], setup["feats"],
                                 jnp.asarray(HW, jnp.int32))
    feats = to_torch_feats(setup["feats"])
    with torch.no_grad():
        got = tg.detect_single_image(setup["model"], feats, tg.pack_box_pyramid(setup["model"], feats), HW)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(det.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(det.scores), atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(det.boxes), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(got.orientations.numpy(), np.asarray(det.orientations), atol=1e-4)


def test_box_head_and_predictor_match_glass_tpu(setup):
    """Including the NCHW flatten order of fc1's input."""
    pooled = np.random.RandomState(1).randn(6, 7, 7, 256).astype(np.float32)
    rh = setup["params"]["roi_heads"]
    x = box_head_apply(CTX, rh["box_head"], jnp.asarray(pooled))
    want = box_predictor_apply(CTX, rh["box_predictor"], x, True)
    m = setup["model"].roi_heads
    with torch.no_grad():
        got = m.box_predictor(m.box_head(torch.from_numpy(pooled)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_fusion_matches_glass_tpu(setup):
    rng = np.random.RandomState(2)
    p2, p3 = rng.randn(1, 32, 40, 256).astype(np.float32), rng.randn(1, 16, 20, 256).astype(np.float32)
    x = rng.randn(3, 8, 32, 512).astype(np.float32)
    rh = setup["params"]["roi_heads"]
    m = setup["model"].roi_heads
    want_fused = p2p3_fusion_apply(CTX, rh["recognizer_feature_fusion"], jnp.asarray(p2), jnp.asarray(p3))
    want_gc = apply_fusion(CTX, rh["fusion_net"], jnp.asarray(x), "MultiAspectGCAttention", "channel_add", 8)
    with torch.no_grad():
        fused = m.recognizer_feature_fusion(nchw(p2), nchw(p3))
        gc = m.fusion_net(nchw(x))
    np.testing.assert_allclose(fused.permute(0, 2, 3, 1).numpy(), np.asarray(want_fused), atol=1e-4)
    np.testing.assert_allclose(gc.permute(0, 2, 3, 1).numpy(), np.asarray(want_gc), atol=1e-4)


def test_local_extractor_matches_glass_tpu(setup):
    crops = np.random.RandomState(3).randn(3, 128, 128, 3).astype(np.float32)
    want = local_extractor_forward(CTX, setup["params"]["roi_heads"]["hybrid_net"]["ConvNet"],
                                   jnp.asarray(crops), "ResNetFeatureExtractor")
    with torch.no_grad():
        got = setup["model"].roi_heads.hybrid_net(nchw(crops))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=2e-3)


def test_recognizer_encoder_matches_glass_tpu(setup):
    x = np.random.RandomState(4).randn(4, 8, 32, 256).astype(np.float32)
    want = recognizer_layers_apply(CTX, setup["params"]["roi_heads"]["recognizer_head"],
                                   jnp.asarray(x), "CNN_V1_1")
    with torch.no_grad():
        got = setup["model"].roi_heads.recognizer_head.encode(nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("eos_bias", [0.0, 40.0])
def test_aster_decode_matches_glass_tpu(setup, eos_bias):
    """eos_bias 40 makes every row emit eos (index 0) at the first step: the
    batch-global break then zero-fills every later step."""
    enc = np.random.RandomState(5).randn(6, 32, 256).astype(np.float32)
    head = setup["model"].roi_heads.recognizer_head.decoder.recognizer.decoder
    params = dict(setup["params"]["roi_heads"]["recognizer_head"]["decoder"])
    params["fc"] = {**params["fc"], "bias": params["fc"]["bias"].at[0].add(eos_bias)}
    want = np.asarray(j_decode(params, jnp.asarray(enc), 6))
    with torch.no_grad():
        head.fc.bias[0] += eos_bias
        try:
            got = aster_decode_greedy(head, torch.from_numpy(enc), 6).numpy()
        finally:
            head.fc.bias[0] -= eos_bias
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if eos_bias:
        assert np.all(got[:, 1:] == 0) and np.all(got[:, 0].argmax(-1) == 0)


def test_recognize_single_image_matches_glass_tpu(setup):
    """Fusion, 8x32 pool (K1), raw crops (K2), local CNN, GC attention,
    encoder and decoder on the padded detection rows, invalid ones included."""
    boxes = np.array([[40, 30, 60, 14, 10], [80, 60, 90, 20, -30], [100, 90, 20, 40, 75],
                      [10, 10, 0.5, 0.5, 0], [0, 0, 0, 0, 0]], np.float32)
    want = np.asarray(jg.recognize_single_image(CTX, setup["jarch"], setup["params"], setup["feats"],
                                                jnp.asarray(setup["norm"]), jnp.asarray(boxes)))
    with torch.no_grad():
        got = tg.recognize_single_image(setup["model"], to_torch_feats(setup["feats"]),
                                        torch.from_numpy(setup["norm"]), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_mask_head_matches_glass_tpu(setup):
    pooled = np.random.RandomState(6).randn(5, 14, 14, 256).astype(np.float32)
    classes = np.zeros(5, np.int32)
    logits = mask_head_apply(CTX, setup["params"]["roi_heads"]["mask_head"], jnp.asarray(pooled), 4)
    want = np.asarray(j_mask_probs(logits, jnp.asarray(classes)))
    with torch.no_grad():
        got = mask_inference_probs(setup["model"].roi_heads.mask_head(nchw(pooled)),
                                   torch.from_numpy(classes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_mask_single_image_matches_glass_tpu(setup):
    """The 14x14 adaptive pool (K1, bulk (1, 2) + budget) and the head."""
    boxes = np.array([[40, 30, 60, 14, 10], [80, 60, 300, 40, -30], [64, 60, 120, 120, 0]], np.float32)
    classes = np.zeros(3, np.int32)
    want = np.asarray(jg.mask_single_image(CTX, setup["jarch"], setup["params"], setup["feats"],
                                           jnp.asarray(boxes), jnp.asarray(classes)))
    feats = to_torch_feats(setup["feats"])
    with torch.no_grad():
        got = tg.mask_single_image(setup["model"], tg.pack_box_pyramid(setup["model"], feats),
                                   torch.from_numpy(boxes), torch.from_numpy(classes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_pack_pyramid_rows(setup):
    feats = to_torch_feats(setup["feats"])
    pyr = tg.pack_box_pyramid(setup["model"], feats)
    sizes = [f.shape[2] * f.shape[3] for f in feats.values()]
    assert pyr.flat.shape == (sum(sizes), 256)
    np.testing.assert_array_equal(pyr.meta[:, 3].numpy(), np.cumsum([0] + sizes[:-1]))
    direct = pack_pyramid([tg.nhwc(feats["p2"])], [0.25])
    assert torch.equal(direct.flat, pyr.flat[: sizes[0]])
