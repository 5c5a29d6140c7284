"""Optimizer and learning-rate schedule.

Counterpart of ``glass_tpu/train/optimizer.py`` (detectron2's
``build_optimizer`` + ``WarmupMultiStepLR``): SGD with momentum and weight
decay by parameter group, with glass_tpu's naming rule:

* ``norm``: BN and LayerNorm scale/bias (a parent named ``norm``, a key
  starting with ``bn``, the GC block's ``channel_add_conv.1``), decayed by
  ``SOLVER.WEIGHT_DECAY_NORM``,
* ``default``: every other parameter, decayed by ``SOLVER.WEIGHT_DECAY``,
* ``frozen``: BN running statistics, which are buffers here and never
  optimized.

``torch.optim.SGD`` with ``weight_decay`` is optax's ``add_decayed_weights``
followed by ``sgd(momentum)``: ``d = g + wd * p``, ``m = momentum * m + d``,
``p -= lr * m`` (Nesterov: ``p -= lr * (d + momentum * m)``).  As in optax,
every parameter takes a step each iteration, one outside the loss graph
(a frozen stage) with a zero gradient, so its weight decay still applies.
Gradient clipping (``SOLVER.CLIP_GRADIENTS``) runs first, by value or by
global norm, with optax's formulas.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def warmup_multistep_schedule(base_lr: float, steps: Sequence[int], gamma: float,
                              warmup_iters: int, warmup_factor: float,
                              warmup_method: str = "linear"):
    """count -> learning rate, in f32 as glass_tpu's schedule."""
    milestones = np.asarray(sorted(steps), np.int64)
    f32 = np.float32

    def schedule(count: int) -> float:
        decay = f32(gamma) ** f32(np.sum(count >= milestones))
        if warmup_iters > 0:
            alpha = np.clip(f32(count) / f32(warmup_iters), f32(0.0), f32(1.0))
            if warmup_method == "linear":
                warm = f32(warmup_factor) * (f32(1.0) - alpha) + alpha
            else:  # constant
                warm = f32(warmup_factor) if count < warmup_iters else f32(1.0)
        else:
            warm = f32(1.0)
        return float(f32(base_lr) * f32(decay) * f32(warm))

    return schedule


def is_norm_param(name: str) -> bool:
    """glass_tpu's ``_is_norm_param`` on a ``state_dict`` name."""
    keys = name.split(".")
    for i, k in enumerate(keys):
        if k == "norm" or k.startswith("bn") or (
            k == "1" and i > 0 and keys[i - 1] == "channel_add_conv"
        ):
            return True
    return False


class GlassOptimizer:
    """SGD over the model's parameter groups, stepped at an iteration's
    learning rate."""

    def __init__(self, cfg, model: torch.nn.Module):
        s = cfg.SOLVER
        self.schedule = warmup_multistep_schedule(
            s.BASE_LR, list(s.STEPS), s.GAMMA, s.WARMUP_ITERS, s.WARMUP_FACTOR, s.WARMUP_METHOD
        )
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        groups = [
            {"params": [p for n, p in named if not is_norm_param(n)], "weight_decay": s.WEIGHT_DECAY,
             "name": "default"},
            {"params": [p for n, p in named if is_norm_param(n)], "weight_decay": s.WEIGHT_DECAY_NORM,
             "name": "norm"},
        ]
        self.sgd = torch.optim.SGD(
            [g for g in groups if g["params"]], lr=s.BASE_LR, momentum=s.MOMENTUM,
            nesterov=s.NESTEROV,
        )
        clip = s.CLIP_GRADIENTS
        self.clip = (clip.CLIP_TYPE, float(clip.CLIP_VALUE)) if clip.ENABLED else None

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def _clip(self) -> None:
        kind, value = self.clip
        grads = [p.grad for p in self.params]
        if kind == "value":  # optax.clip
            for g in grads:
                g.clamp_(-value, value)
            return
        # optax.clip_by_global_norm: t if |g| < max else t / |g| * max
        norm = torch.sqrt(sum(torch.sum(g ** 2) for g in grads))
        for g in grads:
            g.copy_(torch.where(norm < value, g, g / norm * value))

    @torch.no_grad()
    def step(self, iteration: int) -> float:
        """The update of ``iteration`` (0-based, optax's step count); returns
        its learning rate."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip is not None:
            self._clip()
        lr = self.schedule(iteration)
        for g in self.sgd.param_groups:
            g["lr"] = lr
        self.sgd.step()
        return lr

    def state_dict(self) -> dict:
        return self.sgd.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state)


def build_optimizer(cfg, model: torch.nn.Module) -> GlassOptimizer:
    return GlassOptimizer(cfg, model)
