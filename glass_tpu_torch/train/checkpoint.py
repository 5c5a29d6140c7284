"""Checkpoints in detectron2's layout.

``save_checkpoint`` writes ``model_{iter:07d}.pth`` holding ``{"model":
state_dict, "optimizer": ..., "iteration": iter}`` and a ``last_checkpoint``
file naming it, as d2's ``DetectionCheckpointer`` (rank 0 alone in a
process group); glass_tpu's ``load_torch_checkpoint`` reads the same file
(its names are d2's).

``load_torch_checkpoint`` reads every file glass_tpu's reader of that name
reads, into a d2-named ``{name: tensor}`` dict: a ``.pth``/``.pt``, a d2
``.pkl``, a caffe2 ImageNet R-50 trunk ``.pkl`` (mapped onto
``backbone.bottom_up``) and the legacy layout whose recognizer sits at
``roi_heads.mask_head`` (moved to ``roi_heads.recognizer_head``).
``load_weights_`` reads a file so and overlays it onto a model's initialised
weights (glass_tpu's ``overlay_params``): names that match in shape are
loaded, the rest keep their initialisation, and both are logged.  The
training path's ``MODEL.WEIGHTS`` and ``GlassRunner(model_path=)`` both load
through it.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

LAST = "last_checkpoint"


def save_checkpoint(out_dir: str, iteration: int, model: torch.nn.Module, optimizer=None,
                    group=None) -> str:
    """Write ``model_{iteration:07d}.pth`` and ``last_checkpoint``.  With a
    process ``group``, rank 0 writes them (the replicas are equal), then
    every rank waits at a barrier, so every rank resumes from that file."""
    name = f"model_{iteration:07d}.pth"
    path = os.path.join(out_dir, name)
    if group is not None:
        import torch.distributed as dist

        if dist.get_rank(group) == 0:
            save_checkpoint(out_dir, iteration, model, optimizer)
        dist.barrier(group=group)
        return path
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "iteration": int(iteration),
    }
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a crash mid-save keeps the old file
    with open(os.path.join(out_dir, LAST), "w") as f:
        f.write(name)
    return path


def last_checkpoint(out_dir: str) -> Optional[str]:
    marker = os.path.join(out_dir, LAST)
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return os.path.join(out_dir, f.read().strip())


# d2 buffers that glass_tpu's converter drops: the model re-derives them from
# the config (normalization constants, cell anchors, GC attention's
# channel order) or has none (BN's step count, a temperature)
def _dropped(name: str) -> bool:
    parts = name.split(".")
    module = parts[-2] if len(parts) > 1 else ""
    return (parts[-1] in ("num_batches_tracked", "temperature", "order") or module == "temperature"
            or "cell_anchors" in parts or name in ("pixel_mean", "pixel_std"))


# caffe2 R-50 trunk: blocks per stage and branch names (glass_tpu's
# ``_C2_STAGE_BLOCKS`` and ``_C2_BRANCH``)
_C2_STAGE_BLOCKS = {"res2": 3, "res3": 4, "res4": 6, "res5": 3}
_C2_BRANCH = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3", "branch1": "shortcut"}


def convert_caffe2_resnet50(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A caffe2 ImageNet R-50 pickle (``res2_0_branch2a_w``, ``..._bn_s``,
    ``..._bn_b``) -> ``backbone.bottom_up.*``.  Weights stay OIHW (caffe2's
    layout is the port's); BN is an affine scale and bias with its
    statistics absorbed, so it gets identity running statistics."""
    out = {}

    def put(prefix, weight, bn):
        scale = np.asarray(state[f"{bn}_bn_s"], np.float32)
        out[f"{prefix}.weight"] = torch.from_numpy(np.asarray(weight, np.float32))
        out[f"{prefix}.norm.weight"] = torch.from_numpy(scale)
        out[f"{prefix}.norm.bias"] = torch.from_numpy(np.asarray(state[f"{bn}_bn_b"], np.float32))
        out[f"{prefix}.norm.running_mean"] = torch.zeros(len(scale))
        out[f"{prefix}.norm.running_var"] = torch.ones(len(scale))

    put("backbone.bottom_up.stem.conv1", state["conv1_w"], "res_conv1")
    for stage, n_blocks in _C2_STAGE_BLOCKS.items():
        for i in range(n_blocks):
            for c2, ours in _C2_BRANCH.items():
                key = f"{stage}_{i}_{c2}"
                if f"{key}_w" in state:
                    put(f"backbone.bottom_up.{stage}.{i}.{ours}", state[f"{key}_w"], key)
    return out


def remap_legacy_recognizer(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The legacy ``RecognizerROIHeadsV2`` layout registers the recognizer
    as the mask head (``roi_heads.mask_head.{backbone,encoder,decoder}``);
    move it to ``roi_heads.recognizer_head``, as glass_tpu's ``_walk_rename``
    does.  The port keeps d2's nesting below the head, so this is a prefix
    swap.  A real conv mask head (``mask_fcn*``, ``deconv``, ``predictor``)
    has no backbone, encoder or decoder and stays where it is."""
    old, new = "roi_heads.mask_head.", "roi_heads.recognizer_head."
    keys = list(state)
    legacy = (not any(k.startswith(new) for k in keys)
              and any(k.startswith(old + "backbone.") for k in keys)
              and any(k.startswith((old + "encoder.", old + "decoder.")) for k in keys))
    if not legacy:
        return state
    logger.info("legacy layout: the recognizer at %s* moves to %s*", old, new)
    return {(new + k[len(old):] if k.startswith(old) else k): v for k, v in state.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A detectron2 ``.pth``/``.pt`` (``{"model": ...}`` or a bare state
    dict) or ``.pkl`` checkpoint -> a d2-named ``{name: tensor}`` dict.
    Reads local files only."""
    if "://" in path:
        raise FileNotFoundError(
            f"{path}: checkpoints are read from local files only; download it and pass "
            "its path (--weights, or MODEL.WEIGHTS)")
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        state = data.get("model", data)
        state = {k: v for k, v in state.items() if isinstance(v, np.ndarray)}
        if "conv1_w" in state:  # caffe2 ImageNet trunk
            return convert_caffe2_resnet50(state)
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
        state = data.get("model", data)
    state = {k: (v.detach().cpu() if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
             for k, v in state.items() if not _dropped(k)}
    return remap_legacy_recognizer(state)


def load_weights_(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Overlay any checkpoint ``load_torch_checkpoint`` reads onto the
    model's initialised weights: names that match in shape are loaded, the
    rest are logged and keep their initialisation."""
    state = load_torch_checkpoint(path)
    own = model.state_dict()
    loaded = {}
    for k, v in state.items():
        if k not in own:
            logger.warning("checkpoint key not in model, skipped: %s", k)
            continue
        if tuple(v.shape) != tuple(own[k].shape):
            logger.warning("shape mismatch for %s: model %s vs checkpoint %s, skipped",
                           k, tuple(own[k].shape), tuple(v.shape))
            continue
        loaded[k] = v
    missing = sorted(set(own) - set(loaded))
    if missing:
        logger.warning("%d model weights not in the checkpoint keep their init, e.g. %s",
                       len(missing), missing[:5])
    model.load_state_dict(loaded, strict=False)
    logger.info("Loaded %d of %d weights from %s", len(loaded), len(own), path)
    return model
