"""Training losses.

Counterpart of ``glass_tpu/train/losses.py``: fvcore's smooth-L1, the
periodic rotated-box regression losses of the reference
(``sine_loss`` / ``cosine_loss`` / ``sine_square_loss``: smooth-L1 on
(dx, dy, dw, dh) plus ``w_a * f((da_pred - da_gt) / w_a)``) and the masked
cross-entropy helpers of the box, orientation, decoder and mask heads.
Reductions are weighted sums, so padded rows are masked, not dropped.
At the ties of max(x, 0) and |x| the gradients are JAX's (1/2 and 1).
CTC's loss comes with the CTC slice.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient at 0 (1, where torch.abs's is 0)."""
    return torch.where(x >= 0, x, -x)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Elementwise smooth-L1 (beta=0 -> pure L1), fvcore convention."""
    diff = _abs(pred - target)
    if beta < 1e-5:
        return diff
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


def _angle_loss(fn, pred_deltas, gt_deltas, beta: float, weights: Sequence[float]):
    """Per-row loss (..., 5) -> (..., 5): smooth-L1 xywh + periodic angle."""
    box_l1 = smooth_l1(pred_deltas[..., :4], gt_deltas[..., :4], beta)
    angle_weight = weights[4]
    angle_diff = (pred_deltas[..., 4] - gt_deltas[..., 4]) / angle_weight
    angle_l = angle_weight * fn(angle_diff)
    return torch.cat([box_l1, angle_l[..., None]], dim=-1)


def sine_square_loss(pred, gt, beta, weights):
    return _angle_loss(lambda x: torch.sin(x) ** 2, pred, gt, beta, weights)


def sine_loss(pred, gt, beta, weights):
    return _angle_loss(lambda x: _abs(torch.sin(x)), pred, gt, beta, weights)


def cosine_loss(pred, gt, beta, weights):
    return _angle_loss(lambda x: _abs(1.0 - torch.cos(x)), pred, gt, beta, weights)


BOX_REG_LOSSES = {
    "smooth_l1": lambda p, g, beta, w: smooth_l1(p, g, beta),
    "sine_square_loss": sine_square_loss,
    "sine_loss": sine_loss,
    "cosine_loss": cosine_loss,
}


def _masked_mean(loss: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, loss, torch.zeros_like(loss)).sum() / denom


def masked_cross_entropy(logits, labels, mask) -> torch.Tensor:
    """Mean softmax CE over rows where ``mask`` is True (0 if none)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return _masked_mean(nll, mask)


def masked_bce_with_logits(logits, targets, mask) -> torch.Tensor:
    """Mean binary CE over masked elements (torch BCEWithLogits's formula)."""
    logits = logits.to(torch.float32)
    loss = (torch.maximum(logits, logits.new_zeros(())) - logits * targets
            + torch.log1p(torch.exp(-_abs(logits))))
    return _masked_mean(loss, mask)


def decoder_cross_entropy(logits, targets, word_mask) -> torch.Tensor:
    """Recognizer CE with ignore_index 0 on targets shifted by one (the
    reference's ``CE(preds, targets[:, 1:], ignore_index=0)``).

    logits (N, T, V); targets (N, T + 1) with the leading GO slot;
    word_mask (N,) valid words.
    """
    tgt = targets[:, 1 : logits.shape[1] + 1].long()
    mask = (tgt != 0) & word_mask[:, None]
    return masked_cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1), mask.reshape(-1)
    )
