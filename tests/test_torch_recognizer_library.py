"""The recognizer-side modules of the model-family variants, one by one,
against their glass_tpu functions on the CPU.

Each module gets glass_tpu's own parameter tree (its init, every leaf then
redrawn from a seeded numpy stream so biases, LayerNorm affines and BN
statistics are not trivial), carried to the port through
``glass_tpu_torch.weights.state_dict_from_jax_params``, and the same seeded
numpy input.  Narrow widths where the module takes them (fusion at 32
channels, recognizer CNNs and decoders at 16); the extractors glass_tpu
builds at a fixed width (the V2 extractor, ResNet_ASTER) run on small
crops instead.

Tolerances (f32): 1e-4 abs + 1e-4 rel for modules a few layers deep; the
V2 extractor and ResNet_ASTER, 20 and 30 layers of a random network, 2e-3
abs of their output's scale (tests/test_backbone_parity.py's bound).
Beam search: equal tokens, scores 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glass_tpu.models import beam_search as jbeam
from glass_tpu.models import fusion as jfusion
from glass_tpu.models import local_extractor as jlocal
from glass_tpu.models import local_extractor_variants as jvar
from glass_tpu.models import pooler_pad as jpad
from glass_tpu.models import recognizer as jrec
from glass_tpu.models.context import Ctx

from glass_tpu_torch.models import beam_search, fusion, local_extractor, local_extractor_variants as var
from glass_tpu_torch.models import pooler_pad, recognizer
from glass_tpu_torch.weights import state_dict_from_jax_params

torch.set_num_threads(2)
CTX = Ctx(train=False)
KEY = jax.random.PRNGKey(0)


def redraw(tree, seed=0):
    """Every leaf of a glass_tpu tree redrawn (same shapes): weights and
    biases N(0, 1/fan_in)-ish, BN scales near 1, positive variances."""
    rng = np.random.RandomState(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in leaves:
        name = str(path[-1].key)
        shape = np.shape(leaf)
        if name == "running_var":
            v = 0.5 + rng.rand(*shape)
        elif name == "running_mean":
            v = 0.1 * rng.randn(*shape)
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[-1]
            v = rng.randn(*shape) / np.sqrt(fan_in)
        else:
            v = (1.0 if name == "weight" else 0.0) + 0.1 * rng.randn(*shape)
        out.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def load(module, tree):
    """The port module with glass_tpu's tree as its weights (strict)."""
    module.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, tree)))
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# --- fusion ---------------------------------------------------------------

FUSIONS = [("MultiAspectGCAttention", "channel_add"), ("MultiAspectGCAttention", "channel_mul"),
           ("MultiAspectGCAttention", "channel_concat"), ("SimpleAttention", None),
           ("LocalOnly", None), ("Conv1x1", None)]


@pytest.mark.parametrize("name,ftype", FUSIONS, ids=[f"{n}-{t}" for n, t in FUSIONS])
def test_fusion_module_matches_glass_tpu(name, ftype):
    c, headers, out = 32, 8, 16
    tree = redraw(jfusion.init_fusion(KEY, name, ftype or "channel_add", inplanes=c, headers=headers,
                                      outplane=out), seed=1)
    x = np.random.RandomState(2).randn(3, 4, 8, c).astype(np.float32)
    want = jfusion.apply_fusion(CTX, tree, jnp.asarray(x), name, ftype or "channel_add", headers)
    port = load(fusion.build_fusion(name, ftype or "channel_add", c, 0.5, headers, out), tree)
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    close(got, want)


# --- recognizer CNNs, CTC head, decoders ---------------------------------

BACKBONES = ["CNN_V1_1", "CNN_V1", "CNN_V1_RECT", "CNN_V2", "CNN_V2_1", "Identity"]


def backbone_tree(name, c, seed=3):
    """glass_tpu's ``init_recognizer`` backbone (CNN_V1_1's tree for every
    name); CNN_V2's ``conv3``, which only a checkpoint supplies there, is
    added as a copy of conv2's shapes; Identity has no parameters."""
    tree = jrec.init_recognizer(KEY, channels=c, vocab=12)["backbone"]
    if name.startswith("CNN_V2"):
        tree["conv3"] = jax.tree_util.tree_map(lambda a: a, tree["conv2"])
    if name == "Identity":
        tree = {}
    return redraw(tree, seed)


@pytest.mark.parametrize("name", BACKBONES)
def test_recognizer_backbone_matches_glass_tpu(name):
    c = 16
    tree = backbone_tree(name, c)
    x = np.random.RandomState(4).randn(3, 8, 32, c).astype(np.float32)
    want = jrec.RECOGNIZER_BACKBONES[name](CTX, tree, jnp.asarray(x))
    port = load(recognizer.RECOGNIZER_BACKBONES[name](c), tree)
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == {"CNN_V1_RECT": (3, 7, 32, c), "Identity": (3, 8, 32, c)}.get(
        name, (3, 4, 32, c))
    close(got, want)


def test_ctc_logits_match_glass_tpu():
    tree = redraw(jrec.init_recognizer(KEY, channels=16, vocab=12, decoder="CTC")["decoder"], 5)
    x = np.random.RandomState(6).randn(4, 32, 16).astype(np.float32)
    port = load(recognizer.CTCDecoder(12, 16), tree)
    with torch.no_grad():
        got = recognizer.ctc_logits(port, torch.from_numpy(x))
    close(got, jrec.ctc_logits(tree, jnp.asarray(x)))


def aster_decoder(c=16, vocab=12, seed=7, eos_bias=0.0):
    """glass_tpu's ASTER decoder tree (redrawn, the stop symbol's logit
    raised by ``eos_bias``) and the port's ``DecoderUnit`` holding it."""
    tree = redraw(jrec.init_recognizer(KEY, channels=c, vocab=vocab)["decoder"], seed)
    tree["fc"]["bias"] = (tree["fc"]["bias"] + eos_bias * (np.arange(vocab) == 1)).astype(np.float32)
    sd = state_dict_from_jax_params({"roi_heads": {"recognizer_head": {"decoder": tree}}})
    prefix = "roi_heads.recognizer_head.decoder.recognizer.decoder."
    unit = recognizer.DecoderUnit(c, c, vocab, c)
    unit.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return unit.eval(), tree


@pytest.mark.parametrize("width", [1, 3])
def test_beam_search_matches_glass_tpu(width):
    """Words that stop early (a raised stop bias), so beams freeze and
    extend only with the stop symbol."""
    unit, tree = aster_decoder(eos_bias=1.5)
    x = np.random.RandomState(8).randn(5, 6, 16).astype(np.float32)
    want_tok, want_score = jbeam.aster_decode_beam(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), 7, beam_width=width, eos_index=1)
    with torch.no_grad():
        tok, score = beam_search.aster_decode_beam(unit, torch.from_numpy(x), 7, beam_width=width)
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    close(score, want_score)
    assert (np.asarray(want_tok) == 1).any(axis=1).sum() >= 2  # words end, beams freeze


# --- FeatPadV2 --------------------------------------------------------------

def test_feat_pad_v2_boxes_and_mask_match_glass_tpu():
    rng = np.random.RandomState(9)
    boxes = np.stack([rng.uniform(0, 90, 12), rng.uniform(0, 60, 12), rng.uniform(2, 80, 12),
                      rng.uniform(4, 30, 12), rng.uniform(-80, 80, 12)], 1).astype(np.float32)
    boxes[0, 2:4] = (8.0, 0.0)  # a zero-height box: the 1e-6 guard
    want_b, want_r = jpad.feat_pad_v2_boxes(jnp.asarray(boxes), (8, 32))
    got_b, got_r = pooler_pad.feat_pad_v2_boxes(torch.from_numpy(boxes), (8, 32))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    assert (np.asarray(want_r) > 1).sum() >= 3 and (np.asarray(want_r) <= 1).sum() >= 3
    pooled = rng.randn(12, 8, 32, 6).astype(np.float32)
    want = jpad.feat_pad_v2_mask(jnp.asarray(pooled), want_r)
    got = pooler_pad.feat_pad_v2_mask(torch.from_numpy(pooled), got_r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).any()


# --- local extractors ------------------------------------------------------

def test_resnet_feature_extractor_v2_matches_glass_tpu():
    tree = redraw(jlocal.init_local_extractor_v2(KEY), 10)
    crops = np.random.RandomState(11).randn(2, 32, 32, 3).astype(np.float32)
    want = jlocal.local_extractor_forward(CTX, tree, jnp.asarray(crops), "ResNetFeatureExtractorV2")
    port = load(local_extractor.build_local_extractor("ResNetFeatureExtractorV2").ConvNet, tree)
    with torch.no_grad():
        got = port(nchw(crops)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 8, 8, 256)
    close(got, want, atol=2e-3 * float(np.abs(want).max()), rtol=0)


def test_grcl_matches_glass_tpu():
    tree = redraw(jvar.init_grcl(KEY, 4, 8, 2, 3), 12)
    x = np.random.RandomState(13).randn(2, 6, 10, 4).astype(np.float32)
    want = jvar.grcl_apply(CTX, tree, jnp.asarray(x), 2)
    port = load(var.GRCL(4, 8, 2, 3), tree)
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1)
    close(got, want)


def test_resnet_aster_matches_glass_tpu():
    tree = redraw(jvar.init_resnet_aster(KEY, 3), 14)
    x = np.random.RandomState(15).randn(1, 32, 16, 3).astype(np.float32)
    want = jvar.resnet_aster_apply(CTX, tree, jnp.asarray(x))
    port = load(var.ResNet_ASTER(3), tree)
    with torch.no_grad():
        got = port(nchw(x))
    assert got.shape == want.shape == (1, 4, 512)
    close(got, want, atol=2e-3 * float(np.abs(want).max()), rtol=0)


def test_feature_attention_matches_glass_tpu():
    rng = np.random.RandomState(16)
    tree = {"conv": {"weight": rng.randn(3, 3, 6, 5).astype(np.float32) / 7,
                     "bias": rng.randn(5).astype(np.float32)}}
    x = rng.randn(2, 7, 9, 6).astype(np.float32)
    want = jvar.feature_attention_apply(CTX, tree, jnp.asarray(x))
    port = load(var.FeatureAttention(6, 5), tree)
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1)
    close(got, want)
