"""TPU.SERVE_BATCH_MODE="vmap": one batched serving program a batch.

The port's vmap mode (``glass_inference_batch`` behind
``GlassRunner.dispatch_batch``/``collect_batch``) against glass_tpu's,
which ``jax.vmap``s ``glass_inference_single`` over the batch; against the
port's own "map" mode; the per-image break of the greedy decoder; the
batched parts (rotated IoU, NMS, proposal selection, box-head inference,
the crops' plain twin) bit for bit against their one-image versions; the
recognizer options through the batched program; and data-parallel vmap.

The model: the ICDAR15 config at tests/test_batch_inference.py's small
sizes (a 96 x 96 bucket, RPN top-k 64/16, 8 detections, words of 4), f32,
mask inference on, three images of different content sizes in the one
bucket.  Seeded weights in that file's amplified-score setting (the class
and objectness weights times 50), with the box and RPN delta weights
scaled by 0.01 where that file zeroes them: a random model's deltas throw
boxes to the decode clamp and its scores tie, where glass_tpu's own two
modes part by XLA's reordering (0.14 px at the clamp).  Zeroed deltas make
every box an exact anchor (a 45-degree multiple, sizes multiples of
sqrt 2), and one such box put a mask-pool sample on the edge of the
sampling rule: glass_tpu's jitted pooler and its own op-by-op pooler, on
the same features and box, differ there by 3.4 in two bins and by 0.055 in
the mask probabilities (the port agrees with the op-by-op one to 7e-7).
Scaled deltas keep the boxes near the anchors, away from the clamp, in
general position.  The port's weights come back from glass_tpu's tree
(``weights.py``).

Tolerances against glass_tpu (tests/test_torch_slice.py's): ``valid``,
``classes`` equal; boxes 0.05 px + 1e-4 relative; scores and orientations
1e-3; text step scores and mask probabilities 2e-3; text ids equal on
every step before a knife edge (a step whose reference top-two margin is
under 1e-4: a random recognizer's near-flat distributions may pick either
character there, and the greedy decoder feeds that pick on), at most one
such step an image.  vmap against map in the port, each image's fields at
f32 rounding: the batch's convolutions add in another order than one
image's (5e-5 on the FPN maps here): boxes 1e-3 px, scores,
orientations and text step scores 1e-4, mask probabilities one float16
step (2^-11) plus 1e-4, text ids equal.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.inference import GlassRunner as JRunner
from glass_tpu.models.recognizer import aster_decode_greedy as j_decode
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner
from glass_tpu_torch.inference.runner import calibrate_batch_norm_, finish_fetch, random_init_
from glass_tpu_torch.models import GlassArch, GlassRCNN, emit_text
from glass_tpu_torch.models.box_head import fast_rcnn_inference_batch, fast_rcnn_inference_single_image
from glass_tpu_torch.models.recognizer import aster_decode_greedy
from glass_tpu_torch.models.rpn import select_proposals_batch, select_proposals_single_image
from glass_tpu_torch.ops.crop import crop_rois_batched, crop_rois_batched_plain, crop_rois_plain
from glass_tpu_torch.ops.iou_rotated import pairwise_ioa_rotated, pairwise_iou_rotated
from glass_tpu_torch.ops.nms_rotated import nms_rotated_mask, nms_rotated_mask_batched
from glass_tpu_torch.weights import state_dict_from_jax_params

torch.set_num_threads(2)
ICDAR15 = os.path.join(os.path.dirname(__file__), "..", "configs", "glass_finetune_icdar15.yaml")
SMALL = [
    "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96", "TPU.IMAGE_BUCKETS", "[[96, 96]]",
    "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "4", "TEST.DETECTIONS_PER_IMAGE", "8",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.ROI_MASK_HEAD.MASK_INFERENCE", "True",
]
VMAP = ["TPU.SERVE_BATCH_MODE", "vmap"]
HWS = ((90, 96), (64, 80), (96, 70))
_RH = "MODEL.ROI_RECOGNIZER_HEAD."
CTC = [_RH + "RECOGNIZER_HEAD.DECODER.NAME", "CTC", _RH + "LABELS_TYPE", "ctc"]
FEATPAD = [_RH + "RECOGNIZER_HEAD.POOLER_PAD.NAME", "FeatPadV2"]
KNIFE_EDGE = 1e-4
DELTA_SCALE = 0.01
MASK_STEP = 2.0 ** -11


def images(dtype, seed=0):
    """Three images of the HWS content sizes: noise with a few flat
    word-sized blocks."""
    rng = np.random.RandomState(seed)
    out = []
    for h, w in HWS:
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        for _ in range(3):
            y, x = rng.randint(0, h - 14), rng.randint(0, w - 30)
            img[y:y + 10, x:x + 26] = rng.randint(0, 256, 3)
        out.append(img.astype(dtype))
    return out


def separate_scores_(model):
    """tests/test_batch_inference.py's setting, with the box and RPN deltas
    scaled by DELTA_SCALE where that file zeroes them; class and objectness
    weights times 50."""
    with torch.no_grad():
        pred = model.roi_heads.box_predictor
        pred.cls_score.weight.mul_(50.0)
        pred.bbox_pred.weight.mul_(DELTA_SCALE)
        rpn = model.proposal_generator.rpn_head
        rpn.anchor_deltas.weight.mul_(DELTA_SCALE)
        rpn.objectness_logits.weight.mul_(50.0)
    return model


def to_params(state):
    """A port state dict -> glass_tpu's parameter tree (numpy copies), with
    the empty subtrees glass_tpu looks up for modules without tensors."""
    params = _walk_rename(convert_torch_state_dict({k: v.detach().numpy().copy() for k, v in state.items()}))
    rh = params["roi_heads"]
    rh.setdefault("fusion_net", {})
    rh["recognizer_head"].setdefault("backbone", {})
    return jax.tree_util.tree_map(np.asarray, params)


def model_opts(opts):
    """The options among ``opts`` (key, value pairs) that change the
    model's weights."""
    return tuple(x for k, v in zip(opts[::2], opts[1::2]) if k.startswith("MODEL.") for x in (k, v))


@functools.lru_cache(maxsize=None)
def weights(opts=()):
    """(port state dict, glass_tpu params) for the small config plus
    ``opts``: seeded weights in the separated setting, BN statistics
    calibrated on image 0 in its bucket."""
    cfg = get_cfg(ICDAR15, SMALL + list(opts))
    model = separate_scores_(random_init_(GlassRCNN(GlassArch.from_config(cfg)), seed=0).eval())
    pad = np.zeros((96, 96, 3), np.float32)
    pad[:HWS[0][0], :HWS[0][1]] = images(np.float32)[0]
    calibrate_batch_norm_(model, torch.from_numpy(pad), HWS[0])
    params = to_params(model.state_dict())
    return state_dict_from_jax_params(params), params


@functools.lru_cache(maxsize=None)
def port_serve(opts, dtype, serve_devices=()):
    """The port's dispatch_batch/collect_batch on ``images(dtype)`` with the
    weights of ``opts``: (raw fields, Instances)."""
    state, _ = weights(model_opts(opts))
    runner = GlassRunner(cfg=get_cfg(ICDAR15, SMALL + list(opts)), state_dict=state, device="cpu",
                         serve_devices=list(serve_devices) or None)
    fetch, hws = runner.dispatch_batch(images(dtype))
    return finish_fetch(fetch), runner.collect_batch((fetch, hws))


@functools.lru_cache(maxsize=None)
def glass_tpu_serve(opts, dtype):
    """glass_tpu's vmap dispatch_batch/collect_batch on ``images(dtype)``,
    the character distributions fetched (TEXT_EMIT probs)."""
    _, params = weights(model_opts(opts))
    cfg = j_get_cfg(ICDAR15, SMALL + VMAP + list(opts) + ["TPU.TEXT_EMIT", "probs"])
    runner = JRunner(None, cfg=cfg, params=params)
    out, hws = runner.dispatch_batch(images(dtype))
    raw = {k: np.asarray(v) for k, v in jax.device_get(out).items()}
    return raw, runner.collect_batch((out, hws))


def steps_before_knife_edge(want_probs):
    """(B, D, T) mask of the decoding steps before each row's first knife
    edge; at most one knife edge an image."""
    top2 = np.sort(want_probs, axis=-1)[..., -2:]
    edge = (top2[..., 1] - top2[..., 0]) < KNIFE_EDGE
    assert (edge.sum(axis=(1, 2)) <= 1).all(), f"knife-edge steps per image {edge.sum(axis=(1, 2))}"
    return ~np.cumsum(edge, axis=-1).astype(bool)


def assert_text_matches(got, want_probs, atol):
    steps = steps_before_knife_edge(want_probs)
    np.testing.assert_array_equal(got["text_ids"][steps], want_probs.argmax(-1)[steps])
    np.testing.assert_allclose(got["text_step_scores"][steps], want_probs.max(-1)[steps], atol=atol)
    # the steps after each image's break are zero on both sides
    np.testing.assert_array_equal(got["text_step_scores"] == 0, want_probs.max(-1) == 0)


def assert_matches_glass_tpu(got, want, masks=True):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3)
    np.testing.assert_allclose(got["orientations"], want["orientations"], atol=1e-3)
    if masks:
        np.testing.assert_allclose(got["mask_probs"].astype(np.float32), want["mask_probs"].astype(np.float32),
                                   atol=2e-3)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
def test_vmap_runner_matches_glass_tpu(dtype):
    """dispatch_batch/collect_batch under vmap on both sides; the uint8 batch
    under f32 compute crops the raw images with the normalization folded in
    (K2's batched launch, here its plain twin)."""
    got, got_inst = port_serve(tuple(VMAP), dtype)
    want, want_inst = glass_tpu_serve((), dtype)
    assert got["valid"].any(axis=1).all(), "an image without a detection tests nothing"
    assert_matches_glass_tpu(got, want)
    assert_text_matches(got, want["text_probs"], 2e-3)
    for g, w in zip(got_inst, want_inst):
        assert len(g) == len(w) and g.image_size == w.image_size
        np.testing.assert_allclose(np.asarray(g.pred_boxes), np.asarray(w.pred_boxes), atol=0.05, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(g.scores), np.asarray(w.scores), atol=1e-3)
        np.testing.assert_allclose(g.pred_masks, w.pred_masks, atol=2e-3)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
def test_vmap_matches_map(dtype):
    """Every field of every image, vmap against map, at f32 rounding."""
    got, _ = port_serve(tuple(VMAP), dtype)
    want, _ = port_serve((), dtype)
    assert want["valid"].any(axis=1).all()
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
    np.testing.assert_allclose(got["orientations"], want["orientations"], atol=1e-4)
    np.testing.assert_allclose(got["mask_probs"].astype(np.float32), want["mask_probs"].astype(np.float32),
                               atol=MASK_STEP + 1e-4)
    np.testing.assert_allclose(got["text_step_scores"], want["text_step_scores"], atol=1e-4)
    np.testing.assert_array_equal(got["text_ids"], want["text_ids"])


def test_decoder_breaks_per_image():
    """Two images of 4 rows each: image 0's rows all emit eos at the first
    step, image 1's never do.  glass_tpu's decoder under jax.vmap breaks per
    image (its ``jnp.all`` sees one image's rows), so image 0's text step
    scores are zero after the first step and image 1's are not; the port
    decodes the 8 rows as one batch with a group of 4 rows an image.  One
    group of 8 (the single-image break over the whole batch) would break
    no row: image 1 never ends."""
    state, params = weights()
    model = GlassRCNN(GlassArch.from_config(get_cfg(ICDAR15, SMALL))).eval()
    model.load_state_dict(state)
    unit = model.roi_heads.recognizer_head.aster
    c = unit.gru.hidden_size
    y = unit.tgt_embedding.weight.shape[1]
    u = np.where(np.random.RandomState(3).rand(c) < 0.5, -1.0, 1.0).astype(np.float32)
    with torch.no_grad():
        # the GRU's candidate state follows the attention context alone
        # (n = tanh(10 context), z = r = 1/2), and the eos logit is the
        # state's projection on u: +-0.05 c for a context of +-u
        for p in (unit.gru.weight_ih_l0, unit.gru.weight_hh_l0, unit.gru.bias_ih_l0, unit.gru.bias_hh_l0,
                  unit.fc.weight):
            p.zero_()
        unit.gru.weight_ih_l0[2 * c:, y:] = 10.0 * torch.eye(c)
        unit.fc.weight[0] = 0.1 * torch.from_numpy(u)
        unit.fc.bias.copy_(0.1 * torch.randn(unit.fc.bias.shape, generator=torch.Generator().manual_seed(4)))
    noise = 0.01 * np.random.RandomState(5).randn(2, 4, 32, c).astype(np.float32)
    enc = np.stack([u, -u])[:, None, None, :] + noise
    dec = jax.tree_util.tree_map(jnp.asarray, to_params(model.state_dict())["roi_heads"]["recognizer_head"]["decoder"])
    steps = 5
    want = np.asarray(jax.vmap(lambda e: j_decode(dec, e, steps))(jnp.asarray(enc)))
    with torch.no_grad():
        probs = aster_decode_greedy(unit, torch.from_numpy(enc.reshape(8, 32, c)), steps, group=4)
        one_group = aster_decode_greedy(unit, torch.from_numpy(enc.reshape(8, 32, c)), steps)
    got = emit_text(model.arch, probs.view(2, 4, steps, -1))
    np.testing.assert_allclose(probs.view(2, 4, steps, -1).numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(got["text_ids"].numpy(), want.argmax(-1))
    scores = got["text_step_scores"].numpy()
    assert (want[0, :, 0].argmax(-1) == 0).all() and (want[1].argmax(-1) != 0).all()
    assert (scores[0, :, 1:] == 0).all() and (scores[0, :, 0] > 0).all()
    assert (scores[1] > 0).all()
    assert (one_group.amax(-1) > 0).all()


def test_parts_batched_equal_per_image():
    """Rotated IoU/IoA, proposal selection and box-head inference over a
    batch, bit for bit each image's own call."""
    rng = np.random.RandomState(6)

    def boxes(*shape):
        n = int(np.prod(shape))
        b = np.stack([rng.rand(n) * 90, rng.rand(n) * 90, rng.rand(n) * 40 + 1, rng.rand(n) * 15 + 1,
                      rng.choice([0.0, 0.5, 90.0, -45.0, 30.0], n)], 1)
        return torch.from_numpy(b.astype(np.float32).reshape(shape + (5,)))

    b1, b2 = boxes(3, 20), boxes(3, 30)
    for fn in (pairwise_iou_rotated, pairwise_ioa_rotated):
        got = fn(b1, b2)
        assert all(torch.equal(got[i], fn(b1[i], b2[i])) for i in range(3))

    sizes = torch.tensor(HWS, dtype=torch.float32)
    anchors = [boxes(40), boxes(25)]
    logits = [torch.from_numpy(rng.randn(3, a.shape[0]).astype(np.float32)) for a in anchors]
    deltas = [torch.from_numpy(0.2 * rng.randn(3, a.shape[0], 5).astype(np.float32)) for a in anchors]
    logits[1][2] = -1e30  # an image with no proposal on a level
    got = select_proposals_batch(logits, deltas, anchors, sizes, (1.0,) * 5, 32, 16, 0.7)
    for i in range(3):
        want = select_proposals_single_image([lg[i] for lg in logits], [d[i] for d in deltas], anchors,
                                             HWS[i], (1.0,) * 5, 32, 16, 0.7)
        assert all(torch.equal(g[i], w) for g, w in zip(got, want))

    det_boxes, valid = boxes(3, 16), torch.from_numpy(rng.rand(3, 16) < 0.8)
    probs = torch.softmax(torch.from_numpy(rng.randn(3, 16, 2).astype(np.float32)), -1)
    orient = torch.from_numpy(rng.randn(3, 16, 4).astype(np.float32))
    got = fast_rcnn_inference_batch(det_boxes, probs, orient, valid, sizes, 0.05, 0.35, 8)
    for i in range(3):
        want = fast_rcnn_inference_single_image(det_boxes[i], probs[i], orient[i], valid[i], HWS[i],
                                                0.05, 0.35, 8)
        assert all(torch.equal(g[i], w) for g, w in zip(got, want))


@pytest.mark.parametrize("max_keep", [None, 3])
def test_nms_batched_equals_per_image(max_keep):
    """nms_rotated_mask_batched, each row bit for bit nms_rotated_mask on it:
    clustered boxes (long suppression chains), tied scores, an all-invalid
    row."""
    rng = np.random.RandomState(7)
    centres = rng.rand(4, 6, 1, 2) * 80
    xy = (centres + rng.randn(4, 6, 8, 2) * 3).reshape(4, 48, 2)
    wh = rng.rand(4, 48, 2) * 20 + 5
    ang = rng.choice([0.0, 30.0, -60.0], (4, 48, 1))
    boxes = torch.from_numpy(np.concatenate([xy, wh, ang], -1).astype(np.float32))
    scores = torch.from_numpy(np.round(rng.rand(4, 48), 1).astype(np.float32))
    valid = torch.from_numpy(rng.rand(4, 48) < 0.9)
    valid[2] = False
    got = nms_rotated_mask_batched(boxes, scores, 0.3, valid=valid, max_keep=max_keep)
    for i in range(4):
        assert torch.equal(got[i], nms_rotated_mask(boxes[i], scores[i], 0.3, valid=valid[i], max_keep=max_keep))
    assert not got[2].any() and got[0].any()
    if max_keep:
        assert (got.sum(1) <= max_keep).all()


@pytest.mark.parametrize("fold", [True, False], ids=["uint8+fold", "float32"])
@pytest.mark.parametrize("sr", [1, 2, 0])
def test_crop_batched_plain_equals_per_image(fold, sr):
    """K2's batched plain twin is crop_rois_plain on each image, and the
    CPU wrapper of the batched kernel is that twin."""
    rng = np.random.RandomState(8)
    raw = torch.from_numpy(rng.randint(0, 256, (3, 40, 50, 3)).astype(np.uint8))
    mean, std = torch.tensor([103.53, 116.28, 123.675]), torch.tensor([57.375, 57.12, 58.395])
    image = raw if fold else (raw.float() - mean) / std
    normalize = (mean, std) if fold else None
    rois = torch.from_numpy(np.concatenate([
        rng.rand(3, 5, 2) * 50, rng.rand(3, 5, 2) * 30 + 2, rng.rand(3, 5, 1) * 180 - 90], -1).astype(np.float32))
    got = crop_rois_batched_plain(image, rois, (16, 24), sr, 2, normalize)
    for i in range(3):
        assert torch.equal(got[i], crop_rois_plain(image[i], rois[i], (16, 24), sr, 2, normalize))
    assert torch.equal(crop_rois_batched(image, rois, (16, 24), sr, 2, normalize), got)


@pytest.mark.parametrize("opts", [CTC, FEATPAD, ["TPU.TEXT_EMIT", "probs"], ["TPU.MASK_FETCH_DTYPE", "uint8"]],
                         ids=["ctc", "featpad_v2", "text_emit_probs", "mask_fetch_uint8"])
def test_vmap_options_match_glass_tpu(opts):
    """Each option through the batched recognizer (or its outputs), against
    glass_tpu's vmap on the uint8 images."""
    got, _ = port_serve(tuple(opts + VMAP), np.uint8)
    want, _ = glass_tpu_serve(() if "probs" in opts else tuple(opts), np.uint8)
    assert got["valid"].any(axis=1).all()
    uint8_masks = "uint8" in opts
    if uint8_masks:
        assert got["mask_probs"].dtype == want["mask_probs"].dtype == np.uint8
        # one quantization step where the f32 probabilities straddle a half
        assert np.abs(got["mask_probs"].astype(int) - want["mask_probs"].astype(int)).max() <= 1
    assert_matches_glass_tpu(got, want, masks=not uint8_masks)
    if "probs" in opts:
        assert set(got) == set(want)
        steps = steps_before_knife_edge(want["text_probs"])
        np.testing.assert_allclose(got["text_probs"][steps], want["text_probs"][steps], atol=2e-3)
        np.testing.assert_array_equal(got["text_probs"] == 0, want["text_probs"] == 0)
    elif "CTC" in opts:
        # CTC has no decoder break: every step of every row, argmax and max
        np.testing.assert_array_equal(got["text_ids"], want["text_probs"].argmax(-1))
        np.testing.assert_allclose(got["text_step_scores"], want["text_probs"].max(-1), atol=2e-3)
    else:
        assert_text_matches(got, want["text_probs"], 2e-3)


def test_data_parallel_vmap():
    """Two CPU replicas at a batch of 3 (one zero row of 1x1 content pads
    it to 4): each replica's rows equal one replica's vmap program on the
    same rows bit for bit, and the whole equals one replica's batch of 3 at
    f32 rounding."""
    state, _ = weights()
    imgs = images(np.uint8)
    got, _ = port_serve(tuple(VMAP + ["TPU.SERVE_DATA_PARALLEL", "True"]), np.uint8, ("cpu", "cpu"))
    runner = GlassRunner(cfg=get_cfg(ICDAR15, SMALL + VMAP), state_dict=state, device="cpu")
    assert len(runner.replicas) == 1
    batch = torch.zeros((4, 96, 96, 3), dtype=torch.uint8)
    hws = np.ones((4, 2), np.int32)
    for i, im in enumerate(imgs):
        batch[i, :im.shape[0], :im.shape[1]] = torch.from_numpy(im)
        hws[i] = im.shape[:2]
    program = runner.batch_model_fn()
    with torch.inference_mode():
        halves = [program(batch[s:s + 2], hws[s:s + 2]) for s in (0, 2)]
    for k, v in got.items():
        np.testing.assert_array_equal(v, torch.cat([h[k] for h in halves])[:3].numpy(), err_msg=k)
    whole, _ = port_serve(tuple(VMAP), np.uint8)
    np.testing.assert_array_equal(got["valid"], whole["valid"])
    np.testing.assert_allclose(got["boxes"], whole["boxes"], atol=1e-3)
    np.testing.assert_allclose(got["scores"], whole["scores"], atol=1e-4)
