"""Rank bodies of the port's multi-process tests (tests/test_torch_distributed_*.py).

Each function here runs in a process spawned by
``glass_tpu_torch.parallel.mesh.launch``, already in a gloo group, and writes
what it computed to ``<out>/rank<r>.pt`` for the test to read.  The module
imports neither jax nor glass_tpu: the draws of glass_tpu's keys are computed
in the test process and handed over as arrays (``Replay``).
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from glass_tpu_torch.parallel import mesh

# every multi-process test's limits: the group's collective timeout and the
# launch's deadline (the ranks are killed and the test fails past it)
GROUP_TIMEOUT_S = 60
DEADLINE_S = 240
THREADS = 2


def run_ranks(worker, world, args, tmp_path, device="cpu"):
    """Launch ``worker(*args)`` on ``world`` gloo ranks (file rendezvous
    under ``tmp_path``, two torch threads a rank, the limits above)."""
    mesh.launch(worker, world, args=args, device=device, init_method=f"file://{tmp_path}/pg",
                backend="gloo", timeout_s=GROUP_TIMEOUT_S, deadline_s=DEADLINE_S, threads=THREADS)


def load_ranks(out, world):
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def remove_large_files(root):
    """Delete the weights, checkpoints and rank results under ``root``
    (hundreds of MB each at full width) once a test has read them."""
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith((".pth", ".pt")):
                os.remove(os.path.join(dirpath, n))


class Recorder:
    """Wraps a priorities seam and records every draw in call order."""

    def __init__(self, inner):
        self.inner, self.draws = inner, []

    def uniform(self, site, image, shape):
        u = self.inner.uniform(site, image, shape)
        self.draws.append((site, image, u.numpy().copy()))
        return u


class Replay:
    """The priorities seam replaying recorded draws in call order."""

    def __init__(self, draws, device="cpu"):
        self.draws, self.pos, self.device = draws, 0, device

    def uniform(self, site, image, shape):
        want_site, want_image, u = self.draws[self.pos]
        self.pos += 1
        assert (site, image, tuple(u.shape)) == (want_site, want_image, tuple(shape)), (site, image, shape)
        return torch.from_numpy(u).to(self.device)


def torch_batch(batch):
    return {k: (v if k == "content_hw" else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in batch.items()}


def syncbn_worker(out, xs, weight, bias, running_mean, running_var, cotangents):
    """SyncBN on this rank's shard (NCHW): output, running statistics and
    the input, weight and bias gradients of <cotangent, output>."""
    from glass_tpu_torch.models.layers import batch_norm_train

    r = mesh.rank()
    x = torch.from_numpy(xs[r]).requires_grad_()
    w = torch.from_numpy(weight).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    rm, rv = torch.from_numpy(running_mean.copy()), torch.from_numpy(running_var.copy())
    y = batch_norm_train(x, w, b, rm, rv, group=dist.group.WORLD)
    y.backward(torch.from_numpy(cotangents[r]))
    torch.save(dict(out=y.detach(), running_mean=rm, running_var=rv, gx=x.grad, gw=w.grad, gb=b.grad),
               os.path.join(out, f"rank{r}.pt"))


def step_worker(out, sd_path, shards, draws, arch_kw, tcfg_kw):
    """One ``make_parallel_train_step`` on this rank's shard with its
    recorded draws; rank 0 keeps its gradients and state, every rank its
    metrics and whether the replicas agree bit for bit afterwards."""
    from glass_tpu_torch.config import get_cfg
    from glass_tpu_torch.models import GlassArch, GlassRCNN
    from glass_tpu_torch.train.optimizer import build_optimizer
    from glass_tpu_torch.train.train_step import TrainConfig

    r = mesh.rank()
    model = GlassRCNN(GlassArch(**arch_kw))
    model.load_state_dict(torch.load(sd_path, weights_only=True))
    opt = build_optimizer(get_cfg(), model)
    step = mesh.make_parallel_train_step(dist.group.WORLD)
    metrics = step(model, opt, TrainConfig(**tcfg_kw), torch_batch(shards[r]), Replay(draws[r]), 0)
    state = model.state_dict()
    res = dict(metrics={k: float(v) for k, v in metrics.items()},
               agree=mesh.replicas_agree(list(state.values()) + [p.grad for p in model.parameters()]))
    if r == 0:
        res["grads"] = {n: p.grad for n, p in model.named_parameters()}
        res["state"] = state
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


def agree_shape_worker(out, batches):
    """``agree_batch_shape`` of this rank's batch."""
    r = mesh.rank()
    got = mesh.agree_batch_shape(batches[r])
    torch.save(dict(images=torch.from_numpy(got["images"])), os.path.join(out, f"rank{r}.pt"))


def trainer_worker(out, argv):
    """The ``Trainer`` on this rank: the indivisible batch's ValueError,
    two iterations with a periodic ``test()`` at iteration 1 (its metrics as
    this rank's storage saw them, and the images its evaluator scored after
    the gather), then ``resume_or_load`` from the checkpoint and a third
    iteration."""
    from glass_tpu_torch.evaluation import TextEvaluator
    from glass_tpu_torch.train.cli import load_cfg, parse_args
    from glass_tpu_torch.train.trainer import Trainer

    r = mesh.rank()
    res = {"scored": []}
    evaluate = TextEvaluator.evaluate

    def recorded(self):
        out = evaluate(self)
        res["scored"].append(sorted(self._gts))
        return out

    TextEvaluator.evaluate = recorded
    try:
        Trainer(load_cfg(parse_args(argv + ["SOLVER.IMS_PER_BATCH", "3"])), device="cpu")
    except ValueError as e:
        res["indivisible"] = str(e)
    trainer = Trainer(load_cfg(parse_args(argv)), device="cpu")
    trainer.train(max_iter=2)
    storage = trainer.storage
    res["periodic"] = {k: storage.history(k)[-1] for k in storage._history if k.startswith("toy_train/")}
    res["writes_metrics"] = storage._fh is not None
    trainer.resume_or_load(resume=True)
    res["start_iter"] = trainer.start_iter
    trainer.cfg.defrost()
    trainer.cfg.TEST.EVAL_PERIOD = 0  # no second evaluation
    trainer.train(max_iter=3)
    res["agree"] = mesh.replicas_agree(list(trainer.model.state_dict().values()))
    res["state"] = {k: v for k, v in trainer.model.state_dict().items() if "rpn_head" in k}
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


def eval_worker(out, argv):
    """``python -m glass_tpu_torch.eval`` in this rank (the group is set),
    into ``<out>/r<rank>``."""
    from glass_tpu_torch import eval as port_eval

    r = mesh.rank()
    res = port_eval.main(["--output", os.path.join(out, f"r{r}")] + argv)
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


def syncbn_remat_worker(out, image, cotangent):
    """A two-layer conv + SyncBN backbone (seeded, the same on every rank),
    once plain and once through ``train_step.remat_backbone_features`` (the
    checkpointed backbone), from the same state on this rank's image:
    output, parameter gradients, running statistics and the all-reduces
    each issued."""
    from types import SimpleNamespace

    from glass_tpu_torch.models.context import conv_norm
    from glass_tpu_torch.models.glass_rcnn import backbone_features
    from glass_tpu_torch.train.train_step import remat_backbone_features

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = conv_norm(3, 8, 3, 1, 1, relu=True)
            self.b = conv_norm(8, 8, 3, 2, 1)

        def forward(self, x):
            return {"p2": self.b(self.a(x))}

    r = mesh.rank()
    torch.manual_seed(0)
    state = Tiny().state_dict()
    calls = [0]
    inner = dist.all_reduce

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    dist.all_reduce = counted
    res = {}
    for name, fn in (("plain", backbone_features), ("remat", remat_backbone_features)):
        model = SimpleNamespace(backbone=Tiny().train())
        model.backbone.load_state_dict(state)
        calls[0] = 0
        with mesh.sync_batch_norm(model.backbone, dist.group.WORLD):
            y = fn(model, torch.from_numpy(image[r]))["p2"]
            (y * torch.from_numpy(cotangent[r])).sum().backward()
        res[name] = dict(out=y.detach(), all_reduces=calls[0],
                         grads={n: p.grad for n, p in model.backbone.named_parameters()},
                         stats={k: v for k, v in model.backbone.state_dict().items() if "running_" in k})
    dist.all_reduce = inner
    torch.save(res, os.path.join(out, f"rank{r}.pt"))
