"""Every checkpoint format glass_tpu reads, through both port loaders.

The files are built here from a seeded random model: a d2 ``.pth`` (with
the buffers d2 exports and glass_tpu drops), the legacy layout with the
recognizer registered as the mask head, a d2 ``.pkl`` and a caffe2 ImageNet
R-50 trunk ``.pkl``, plus a d2 ``.pth`` holding only a real conv mask head.
Each goes through ``GlassRunner(model_path=)`` and the training path's
``load_weights_``, onto a model initialised from another seed, and through
glass_tpu's ``load_torch_checkpoint`` + ``overlay_params`` onto the same
initial weights, back to names by ``state_dict_from_jax_params``.

Tolerance: none.  Every tensor of the port's model equals glass_tpu's bit
for bit, loaded or kept at its initial value alike.
"""

import os
import pickle
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict
from glass_tpu.train.checkpoint import load_torch_checkpoint as j_load_torch_checkpoint
from glass_tpu.train.checkpoint import overlay_params

from glass_tpu_torch.inference import runner as runner_mod
from glass_tpu_torch.inference.runner import GlassRunner, random_init_
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.train.checkpoint import (
    load_torch_checkpoint,
    load_weights_,
    remap_legacy_recognizer,
)
from glass_tpu_torch.weights import state_dict_from_jax_params

torch.set_num_threads(2)
ARCH_KW = dict(rpn_pre_nms_topk=64, rpn_post_nms_topk=16, detections_per_image=8, max_word_len=5)
REC, MASK = "roi_heads.recognizer_head.", "roi_heads.mask_head."
ICDAR15 = os.path.join(os.path.dirname(__file__), "..", "configs", "glass_finetune_icdar15.yaml")


def _runner_load(model, path):
    """``GlassRunner(model_path=)``, handed ``model`` in place of the one it
    would build, so that both loaders start from the same weights."""
    with mock.patch.object(runner_mod, "GlassRCNN", lambda arch: model):
        GlassRunner(model_path=path, config_path=ICDAR15, device="cpu")
    return model


LOADERS = {"runner": _runner_load, "train": load_weights_}


def _numpy(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def caffe2_trunk(seed=0):
    """A caffe2 R-50 pickle's arrays (tests/test_caffe2_converter.py)."""
    rng = np.random.RandomState(seed)
    state = {"conv1_w": rng.randn(64, 3, 7, 7).astype(np.float32),
             "res_conv1_bn_s": rng.randn(64).astype(np.float32),
             "res_conv1_bn_b": rng.randn(64).astype(np.float32)}
    cin = 64
    for stage, (n, mid, cout) in {"res2": (3, 64, 256), "res3": (4, 128, 512),
                                  "res4": (6, 256, 1024), "res5": (3, 512, 2048)}.items():
        for i in range(n):
            bin_ = cin if i == 0 else cout
            shapes = {"branch2a": (mid, bin_, 1, 1), "branch2b": (mid, mid, 3, 3),
                      "branch2c": (cout, mid, 1, 1)}
            if i == 0:
                shapes["branch1"] = (cout, bin_, 1, 1)
            for br, shp in shapes.items():
                key = f"{stage}_{i}_{br}"
                state[f"{key}_w"] = rng.randn(*shp).astype(np.float32)
                state[f"{key}_bn_s"] = rng.randn(shp[0]).astype(np.float32)
                state[f"{key}_bn_b"] = rng.randn(shp[0]).astype(np.float32)
        cin = cout
    return state


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    arch = GlassArch(**ARCH_KW)
    sd = _numpy(random_init_(GlassRCNN(arch), seed=0).state_dict())
    base = _numpy(random_init_(GlassRCNN(arch), seed=1).state_dict())
    paths = {}

    d2 = {k: torch.from_numpy(v) for k, v in sd.items()}
    d2.update({"pixel_mean": torch.zeros(3, 1, 1), "pixel_std": torch.ones(3, 1, 1),
               "backbone.bottom_up.stem.conv1.norm.num_batches_tracked": torch.tensor(7)})
    paths["d2_pth"] = str(tmp / "d2.pth")
    torch.save({"model": d2, "iteration": 10}, paths["d2_pth"])

    legacy = {(MASK + k[len(REC):] if k.startswith(REC) else k): torch.from_numpy(v)
              for k, v in sd.items() if not k.startswith(MASK)}
    paths["legacy_pth"] = str(tmp / "legacy.pth")
    torch.save(legacy, paths["legacy_pth"])

    paths["d2_pkl"] = str(tmp / "d2.pkl")
    with open(paths["d2_pkl"], "wb") as f:
        pickle.dump({"model": sd, "__author__": "test", "matching_heuristics": True}, f)

    trunk = caffe2_trunk()
    paths["caffe2_pkl"] = str(tmp / "R-50.pkl")
    with open(paths["caffe2_pkl"], "wb") as f:
        pickle.dump(trunk, f)

    paths["mask_head_pth"] = str(tmp / "mask_head.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items() if k.startswith(MASK)}},
               paths["mask_head_pth"])
    return dict(arch=arch, sd=sd, base=base, trunk=trunk, paths=paths)


def _port_load(files, fmt, loader):
    model = GlassRCNN(files["arch"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in files["base"].items()})
    LOADERS[loader](model, files["paths"][fmt])
    return _numpy(model.state_dict())


def _glass_tpu_load(files, fmt):
    init = _walk_rename(convert_torch_state_dict(files["base"]))
    params = overlay_params(init, j_load_torch_checkpoint(files["paths"][fmt]))
    return _numpy(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))


@pytest.mark.parametrize("loader", sorted(LOADERS))
@pytest.mark.parametrize("fmt", ["d2_pth", "legacy_pth", "d2_pkl", "caffe2_pkl", "mask_head_pth"])
def test_loaders_equal_glass_tpu(files, fmt, loader):
    got, want = _port_load(files, fmt, loader), _glass_tpu_load(files, fmt)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # what the file held was loaded, the rest kept its initial value
    loaded = {k for k in got if not np.array_equal(got[k], files["base"][k])}
    if fmt in ("d2_pth", "d2_pkl"):
        assert all(np.array_equal(got[k], files["sd"][k]) for k in got)
    elif fmt == "legacy_pth":
        rec = [k for k in got if k.startswith(REC)]
        assert len(rec) == 43 and all(np.array_equal(got[k], files["sd"][k]) for k in rec)
        assert not any(k.startswith(MASK) for k in loaded)  # no conv mask head in the file
    elif fmt == "caffe2_pkl":
        assert loaded and all(k.startswith("backbone.bottom_up.") for k in loaded)
        np.testing.assert_array_equal(got["backbone.bottom_up.res3.0.conv2.weight"],
                                      files["trunk"]["res3_0_branch2b_w"])
        np.testing.assert_array_equal(got["backbone.bottom_up.res5.2.conv3.norm.running_var"], 1.0)
    else:  # a real conv mask head stays the mask head
        assert loaded and all(k.startswith(MASK) for k in loaded)


def test_caffe2_trunk_sets_every_trunk_tensor(files):
    """Every bottom-up tensor comes from the trunk: 53 convolutions, each
    with its weight and its four BN tensors."""
    state = load_torch_checkpoint(files["paths"]["caffe2_pkl"])
    own = GlassRCNN(files["arch"]).state_dict()
    trunk = [k for k in own if k.startswith("backbone.bottom_up.")]
    assert sorted(state) == sorted(trunk) and len(trunk) == 53 * 5
    assert all(tuple(state[k].shape) == tuple(own[k].shape) for k in trunk)


def test_legacy_remap_keeps_a_real_mask_head():
    """The legacy remap moves the recognizer only when the mask head holds
    one and no recognizer head exists: a conv mask head beside a
    recognizer, or alone, stays where it is."""
    t = torch.zeros(1)
    both = {MASK + "mask_fcn1.weight": t, REC + "backbone.conv1.weight": t}
    assert remap_legacy_recognizer(both) is both
    alone = {MASK + "mask_fcn1.weight": t, MASK + "predictor.weight": t}
    assert remap_legacy_recognizer(alone) is alone
    no_head = {MASK + "backbone.conv1.weight": t}  # a backbone but no encoder or decoder
    assert remap_legacy_recognizer(no_head) is no_head
    legacy = {MASK + "backbone.conv1.weight": t, MASK + "decoder.recognizer.decoder.fc.weight": t}
    assert sorted(remap_legacy_recognizer(legacy)) == [REC + "backbone.conv1.weight",
                                                       REC + "decoder.recognizer.decoder.fc.weight"]


@pytest.mark.parametrize("loader", sorted(LOADERS))
def test_network_paths_fail_like_glass_tpu(files, loader):
    """glass_pretrain.yaml's MODEL.WEIGHTS names a detectron2:// file;
    nothing is fetched, and the message says to pass a local file."""
    url = "detectron2://ImageNetPretrained/MSRA/R-50.pkl"
    with pytest.raises(FileNotFoundError, match="--weights"):
        LOADERS[loader](GlassRCNN(files["arch"]), url)
    with pytest.raises(FileNotFoundError):
        j_load_torch_checkpoint(url)
    assert not os.path.exists("detectron2:")
