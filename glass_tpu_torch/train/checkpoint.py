"""Checkpoints in detectron2's layout.

``save_checkpoint`` writes ``model_{iter:07d}.pth`` holding ``{"model":
state_dict, "optimizer": ..., "iteration": iter}`` and a ``last_checkpoint``
file naming it, as d2's ``DetectionCheckpointer``; glass_tpu's
``load_torch_checkpoint`` reads the same file (its names are d2's).
``load_weights_`` is the partial load of any d2-shaped ``.pth``
(glass_tpu's ``overlay_params``): names that match in shape are loaded,
the rest keep their initialisation, and both are logged.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

LAST = "last_checkpoint"


def save_checkpoint(out_dir: str, iteration: int, model: torch.nn.Module, optimizer=None) -> str:
    name = f"model_{iteration:07d}.pth"
    path = os.path.join(out_dir, name)
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


def load_weights_(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Overlay a d2-shaped ``.pth`` (``{"model": ...}`` or a bare state
    dict) onto the model's initialised weights."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    state = data.get("model", data)
    own = model.state_dict()
    loaded = {}
    for k, v in state.items():
        if k not in own:
            logger.warning("checkpoint key not in model, skipped: %s", k)
            continue
        v = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
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
