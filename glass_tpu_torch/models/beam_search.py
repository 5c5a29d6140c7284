"""Beam-search decoding for the ASTER attention decoder, as a library.

Counterpart of ``glass_tpu/models/beam_search.py`` (reference
``prediction_aster.py:101-222``, dead code there; nothing in glass_tpu
calls it): a fixed-width beam over ``num_steps`` decode steps with batched
gathers and a top-k, the sequences carried forward (no backtracking pass).
A finished beam (it emitted ``eos``) is frozen: it extends only with
``eos``, at no cost.

``jax.lax.top_k`` puts the lower index first among equal values.  Frozen
beams (-1e30 outside ``eos``) and the initial -1e30 beams make exact ties;
a beam picked from them stays near -1e30 and is never the best, but the
top-k here is a stable descending sort all the same, so every beam is
glass_tpu's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import layers as L
from .recognizer import DecoderUnit

NEG_INF = -1e30
EOS_INDEX = 1  # the codec's [s] in attention mode


def _top_k_stable(x: torch.Tensor, k: int):
    """Row-wise top-k of (N, M): values descending, ties by lower index."""
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def aster_decode_beam(decoder: DecoderUnit, x: torch.Tensor, num_steps: int,
                      beam_width: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode of encoder states x (N, T, C).

    Returns the best beam's tokens (N, num_steps) int32 and its total
    log-probability (N,).
    """
    n = x.shape[0]
    k = beam_width
    sdim = decoder.gru.weight_hh_l0.shape[1]
    vocab = decoder.fc.weight.shape[0]
    dev = x.device

    x_rep = torch.repeat_interleave(x, k, dim=0)  # (N*K, T, C)
    xe = decoder.attention_unit.xEmbed
    x_proj = L.linear(x_rep, xe.weight, xe.bias)
    scores = torch.full((n, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    frozen = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=dev)
    frozen[EOS_INDEX] = 0.0
    state = torch.zeros((n * k, sdim), dtype=x.dtype, device=dev)
    y_prev = torch.zeros((n, k), dtype=torch.int64, device=dev)
    tokens = torch.zeros((n, k, num_steps), dtype=torch.int64, device=dev)
    done = torch.zeros((n, k), dtype=torch.bool, device=dev)
    for t in range(num_steps):
        logits, new_state = decoder.step(x_rep, x_proj, state, y_prev.reshape(-1))
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(n, k, vocab)
        logp = torch.where(done[:, :, None], frozen, logp)
        total = scores[:, :, None] + logp
        scores, idx = _top_k_stable(total.reshape(n, k * vocab), k)
        parent = idx // vocab
        token = idx % vocab
        done = torch.gather(done, 1, parent) | (token == EOS_INDEX)
        tokens = torch.gather(tokens, 1, parent[:, :, None].expand(n, k, num_steps)).clone()
        tokens[:, :, t] = token
        state = torch.gather(new_state.reshape(n, k, sdim), 1,
                             parent[:, :, None].expand(n, k, sdim)).reshape(n * k, sdim)
        y_prev = token
    best = torch.argmax(scores, dim=1)
    rows = torch.arange(n, device=dev)
    return tokens[rows, best].to(torch.int32), scores[rows, best]
