"""The plain reference of a training step: the copy of the GLASS training
forward in ``reference/glass/train`` at float32 (TF32 off), autograd's
backward through plain poolers and crops, and the copy of the port's SGD
(parameter groups, warm-up schedule, momentum, weight decay).

``follow`` runs the first steps of a training run from the same weights,
batches and random draws as the program, with each step's proposals
replayed from the program (``proposals``): the selection is a discrete
choice that rounding may turn, and the benchmark judges it on its own
against the program's RPN outputs.
"""

from __future__ import annotations

import torch

from .glass.models.glass_rcnn import GlassRCNN
from .glass.train.optimizer import build_optimizer
from .glass.train.train_step import Priorities, TrainConfig, glass_train_forward
from .runner import build_model


def follow(cfg, state_dict: dict, batches: list, prior_seed: int, iteration0: int, proposals: list,
           device) -> dict:
    """The reference's readings over ``len(batches)`` steps: each step's
    total loss, each leaf's first gradient as the optimizer takes it (the
    momentum buffer after one step: the gradient plus weight decay) and
    each leaf's change over all the steps; both also as float32 tensors on
    the host (``grads_t``, ``change_t``); and each leaf's number of
    dimensions."""
    model: GlassRCNN = build_model(cfg, state_dict, device).train()
    tcfg = TrainConfig.from_config(cfg)
    opt = build_optimizer(cfg, model)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, grads = [], None
    for k, batch in enumerate(batches):
        opt.zero_grad()
        total, _ = glass_train_forward(model, tcfg, batch, Priorities(prior_seed, iteration0 + k, device),
                                       proposals=proposals[k])
        total.backward()
        opt.step(iteration0 + k)
        losses.append(float(total.detach()))
        if k == 0:
            first = {n: opt.sgd.state[p]["momentum_buffer"] for n, p in model.named_parameters()}
            grads, grads_t = leaf_norms(first), on_host(first)
    change_t = on_host({n: p.detach() - start[n] for n, p in model.named_parameters()})
    return {"losses": losses, "grads": grads, "change": leaf_norms(change_t), "grads_t": grads_t,
            "change_t": change_t, "dims": {n: p.dim() for n, p in model.named_parameters()}}


def leaf_norms(leaves: dict) -> dict:
    return {n: float(torch.linalg.norm(t.double())) for n, t in leaves.items()}


def on_host(leaves: dict) -> dict:
    """Each leaf as a float32 tensor on the host."""
    return {n: t.detach().to("cpu", torch.float32, copy=True) for n, t in leaves.items()}
