"""Checkpoints of the model-family variants: a port ``state_dict`` of each
option round-trips through glass_tpu's ``load_torch_checkpoint`` and the
port's ``weights.state_dict_from_jax_params``, bit for bit, both ways.

* port -> glass_tpu -> port: the recognizer side of the port's model
  (``roi_heads.{recognizer_feature_fusion,hybrid_net,fusion_net,
  recognizer_head}``) saved as a d2 ``.pth``, read by glass_tpu's reader and
  by the port's own, and carried back by ``state_dict_from_jax_params``:
  the same names, every tensor equal.
* glass_tpu -> port -> glass_tpu: the tree of glass_tpu's own init of
  those subtrees (``init_p2p3_fusion``, ``init_local_extractor_by_name``,
  ``init_fusion``, ``init_recognizer``: its names and shapes, the leaves
  drawn from a seeded stream) loaded strictly into the port's model,
  saved, and read back by glass_tpu's reader: the same tree, every leaf
  equal.  The trees: glass_tpu's init builds CNN_V1_1's recognizer tree for every
  backbone name, so CNN_V2's ``conv3`` (which only a checkpoint supplies
  there) is added to it, and the Identity backbone, which reads no tensor,
  takes a tree without the backbone's; LocalOnly's ``fusion_net`` is empty
  on both sides.  ResNetFeatureExtractorV2, which no model with the
  recognizer on can hold, goes through as the ``hybrid_net`` alone.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

from glass_tpu.models import fusion as jfusion
from glass_tpu.models import local_extractor as jlocal
from glass_tpu.models import recognizer as jrec
from glass_tpu.train.checkpoint import load_torch_checkpoint as j_load

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.models.local_extractor import build_local_extractor
from glass_tpu_torch.train.checkpoint import load_torch_checkpoint
from glass_tpu_torch.weights import state_dict_from_jax_params

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICDAR15 = os.path.join(ROOT, "configs", "glass_finetune_icdar15.yaml")
REC = "MODEL.ROI_RECOGNIZER_HEAD."
OPTIONS = {
    "FeatPadV2": [REC + "RECOGNIZER_HEAD.POOLER_PAD.NAME", "FeatPadV2"],
    "channel_mul": ["MODEL.HYBRID_FUSION.FUSION_TYPE", "channel_mul"],
    "channel_concat": ["MODEL.HYBRID_FUSION.FUSION_TYPE", "channel_concat"],
    "SimpleAttention": ["MODEL.HYBRID_FUSION.NAME", "SimpleAttention"],
    "LocalOnly": ["MODEL.HYBRID_FUSION.NAME", "LocalOnly"],
    "Conv1x1": ["MODEL.HYBRID_FUSION.NAME", "Conv1x1"],
    "CNN_V1_RECT": [REC + "RECOGNIZER_HEAD.BACKBONE.NAME", "CNN_V1_RECT"],
    "CNN_V2": [REC + "RECOGNIZER_HEAD.BACKBONE.NAME", "CNN_V2"],
    "Identity": [REC + "RECOGNIZER_HEAD.BACKBONE.NAME", "Identity"],
    "CTC": [REC + "RECOGNIZER_HEAD.DECODER.NAME", "CTC", REC + "LABELS_TYPE", "ctc"],
    "ResNetFeatureExtractorV2": [],
}
SIDE = ("roi_heads.recognizer_feature_fusion.", "roi_heads.hybrid_net.", "roi_heads.fusion_net.",
        "roi_heads.recognizer_head.")


@functools.lru_cache(maxsize=None)
def _built(option):
    if option == "ResNetFeatureExtractorV2":
        model = nn.Module()
        model.roi_heads = nn.Module()
        model.roi_heads.hybrid_net = build_local_extractor(option)
        return model
    return GlassRCNN(GlassArch.from_config(get_cfg(ICDAR15, OPTIONS[option])))


def port_model(option):
    """The port's module holding the option's recognizer side (built once
    an option), whose weights are drawn anew from a seeded stream."""
    model = _built(option)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in side(model.state_dict()).values():
            if p.is_floating_point():
                p.copy_(torch.randn(p.shape, generator=gen))
    return model


def side(state):
    return {k: v for k, v in state.items() if k.startswith(SIDE)}


def jax_tree(option, arch):
    """The tree of glass_tpu's init of the option's recognizer-side
    subtrees: its names and shapes (``jax.eval_shape``, no compile), every
    leaf drawn from a seeded numpy stream."""
    def init():
        ks = jax.random.split(jax.random.PRNGKey(1), 4)
        if option == "ResNetFeatureExtractorV2":
            return {"hybrid_net": {"ConvNet": jlocal.init_local_extractor_by_name(ks[1], option)}}
        return {
            "recognizer_feature_fusion": jfusion.init_p2p3_fusion(ks[0]),
            "hybrid_net": {"ConvNet": jlocal.init_local_extractor_by_name(ks[1], arch.local_extractor_name)},
            "fusion_net": jfusion.init_fusion(ks[2], arch.fusion_name, arch.fusion_type, inplanes=512,
                                              headers=arch.gc_headers),
            "recognizer_head": jrec.init_recognizer(ks[3], 256, arch.vocab_size,
                                                    decoder=arch.recognizer_decoder),
        }

    rh = jax.eval_shape(init)
    if option == "CNN_V2":
        rh["recognizer_head"]["backbone"]["conv3"] = rh["recognizer_head"]["backbone"]["conv2"]
    if option == "Identity":
        del rh["recognizer_head"]["backbone"]
    rng = np.random.RandomState(1)
    return {"roi_heads": jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), rh)}


def _leaves(tree):
    """(path, array) of every leaf; empty subtrees hold none."""
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_port_state_dict_round_trips_through_glass_tpu(option, tmp_path):
    model = port_model(option)
    sd = side(model.state_dict())
    path = str(tmp_path / "model.pth")
    torch.save({"model": sd}, path)
    back = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, j_load(path)))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    own = load_torch_checkpoint(path)
    assert set(own) == set(sd) and all(torch.equal(own[k], v) for k, v in sd.items())


@pytest.mark.parametrize("option", list(OPTIONS))
def test_glass_tpu_tree_round_trips_through_the_port(option, tmp_path):
    model = port_model(option)
    arch = getattr(model, "arch", None)
    tree = jax_tree(option, arch)
    missing, unexpected = model.load_state_dict(state_dict_from_jax_params(tree), strict=False)
    assert not unexpected and not side({k: None for k in missing})
    path = str(tmp_path / "model.pth")
    torch.save({"model": side(model.state_dict())}, path)
    want, got = _leaves(tree), _leaves(j_load(path))
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], v) for k, v in want.items())
