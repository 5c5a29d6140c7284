"""Weights carried across from glass_tpu's parameter tree.

``state_dict_from_jax_params`` is the exact inverse of glass_tpu's
``convert_torch_state_dict`` + ``_walk_rename`` (``glass_tpu/train/
checkpoint.py``): it takes the nested dict of numpy arrays that
``init_glass_params`` (or a loaded checkpoint) gives after ``np.asarray``
and returns the port's ``state_dict``, whose names are detectron2's:

* conv weights HWIO -> OIHW; the deconv's (kh, kw, out, in) -> PyTorch's
  (in, out, kh, kw) (the same transpose),
* the GC-attention bottleneck's linear (out, in) -> 1x1 conv (out, in, 1, 1)
  under each fusion type's name (``channel_{add,mul,concat}_conv``;
  ``cat_conv`` is a conv already),
* linear weights (SimpleAttention's ``linear``, the CTC head's ``fc``) and
  recurrent weights keep their (gate-packed) layout; LSTM ``fwd``/``bwd``
  -> ``*_l0`` / ``*_l0_reverse``, GRU -> ``*_l0``,
* the recognizer's ``encoder.{i}`` -> ``encoder.bilsm_stack.{i}`` and the
  ASTER decoder's ``decoder.*`` -> ``decoder.recognizer.decoder.*``; the
  CTC decoder (a tree with no ``gru``) stays ``decoder.fc``.

The backbone, extractor and library variants (``models/
local_extractor_variants.py``) take their names from glass_tpu's tree as
they are.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


GC_BOTTLENECKS = ("channel_add_conv", "channel_mul_conv", "channel_concat_conv")


def _torch_name(path, aster: bool = True) -> str:
    parts = list(path)
    if parts[:2] == ["roi_heads", "recognizer_head"]:
        if parts[2] == "encoder":
            parts.insert(3, "bilsm_stack")
        elif parts[2] == "decoder" and aster:
            parts[3:3] = ["recognizer", "decoder"]
    if "rnn" in parts and parts[-2] in ("fwd", "bwd"):
        suffix = "_reverse" if parts[-2] == "bwd" else ""
        parts[-2:] = [f"{parts[-1]}_l0{suffix}"]
    elif "gru" in parts:
        parts[-1] = f"{parts[-1]}_l0"
    return ".".join(parts)


def state_dict_from_jax_params(params: dict) -> Dict[str, torch.Tensor]:
    """glass_tpu parameter tree (numpy leaves) -> port ``state_dict``."""
    out = {}
    decoder = params.get("roi_heads", {}).get("recognizer_head", {}).get("decoder", {})
    aster = "fc" not in decoder or "gru" in decoder
    for path, value in _flatten(params):
        v = np.asarray(value, dtype=np.float32)
        if path[-1] == "weight" and len(path) >= 3 and path[-3] in GC_BOTTLENECKS and v.ndim == 2:
            v = v[:, :, None, None]
        elif path[-1] == "weight" and v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        out[_torch_name(path, aster)] = torch.tensor(v)
    return out
