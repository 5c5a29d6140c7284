"""Training losses.

Counterpart of ``glass_tpu/train/losses.py``: fvcore's smooth-L1, the
periodic rotated-box regression losses of the reference
(``sine_loss`` / ``cosine_loss`` / ``sine_square_loss``: smooth-L1 on
(dx, dy, dw, dh) plus ``w_a * f((da_pred - da_gt) / w_a)``) and the masked
cross-entropy helpers of the box, orientation, decoder and mask heads.
Reductions are weighted sums, so padded rows are masked, not dropped.
At the ties of max(x, 0) and |x| the gradients are JAX's (1/2 and 1).
``ctc_loss_masked`` is glass_tpu's (``optax.ctc_loss``): its log-space
forward with ``LOG_EPSILON`` standing for log 0, so a word that its T steps
cannot hold (too long, or too many repeated letters) gets a large finite
loss, where ``torch.nn.functional.ctc_loss`` gives inf.
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


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with JAX's arithmetic: max + log1p(exp(-|a - b|)),
    and its gradient exp(a - out), exp(b - out).  On a word its steps
    cannot hold, both inputs sit near ``LOG_EPSILON`` (-1e5), where f32
    keeps only ~0.01 of their difference: the gradient then depends on
    this very formula (torch.logaddexp's sigmoid form moved such a word's
    loss gradient by 1.75e-3 relative L2 from optax's)."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_logaddexp = _LogAddExp.apply

LOG_EPSILON = -1e5  # optax's stand-in for log 0


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, label_paddings: torch.Tensor) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood, optax's ``ctc_loss``
    arithmetic (no logit padding, blank at index 0 as the codec's ctc
    layout fixes it): logits (B, T, K); labels (B, N) right-padded,
    label_paddings (B, N) 1.0 on the padding.  -> (B,)."""
    b, t_steps, _ = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = n - label_paddings.sum(dim=1).to(torch.int64)
    # repeat[b, n] == 1 when label[b, n] == label[b, n + 1]
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logits.dtype)
    repeat = torch.cat([repeat, repeat.new_zeros((b, 1))], dim=1)
    logprobs_phi = logprobs[:, :, :1]  # (B, T, 1)
    logprobs_emit = torch.gather(logprobs, 2, labels.long()[:, None, :].expand(b, t_steps, n))

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], _logaddexp(phi[:, 1:], added)], dim=-1)

    phi = torch.cat([logits.new_zeros((b, 1)), logits.new_full((b, n), LOG_EPSILON)], dim=1)
    emit = logits.new_full((b, n), LOG_EPSILON)
    for t in range(t_steps):
        lp_emit, lp_phi = logprobs_emit[:, t], logprobs_phi[:, t]
        prev_phi = update_phi(phi, emit + LOG_EPSILON * repeat)
        next_emit = _logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi, emit + lp_phi + LOG_EPSILON * (1.0 - repeat))
        phi, emit = next_phi, next_emit
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]


def ctc_loss_masked(logits: torch.Tensor, targets: torch.Tensor, word_mask: torch.Tensor) -> torch.Tensor:
    """CTC negative log-likelihood averaged over valid words.

    logits (N, T, V) per-step logits (blank = index 0, the codec's ctc
    layout); targets (N, L) encoded labels, 0-padded (no GO/STOP in ctc
    mode); word_mask (N,) valid words.
    """
    logits = logits.to(torch.float32)
    per_word = ctc_loss(logits, targets, (targets == 0).to(torch.float32))
    w = word_mask.to(torch.float32)
    return (per_word * w).sum() / torch.clamp(w.sum(), min=1.0)
