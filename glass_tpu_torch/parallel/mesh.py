"""Data parallelism over ``torch.distributed``: one process per device.

Counterpart of ``glass_tpu/parallel/mesh.py``, which drives every chip from
one program through a ``jax.sharding.Mesh``.  The reference launched one
process per GPU (detectron2 ``launch`` + DDP + NCCL SyncBN); the port does
the same:

* a process group per run: from the environment (``torchrun``, or
  ``--distributed``), or spawned one process per local device by
  ``launch``; NCCL on CUDA, gloo on the CPU;
* each rank holds a full replica and the batch rows of its shard
  (``shard_batch``; the loader reads ``records[rank::world]``);
* the step (``make_parallel_train_step``) is glass_tpu's ``shard_map``
  body: each rank's loss and backward, then ONE flat all-reduce mean of
  the gradients, the BN running statistics, ``total`` and every loss and
  metric (glass_tpu's ``pmean`` of grads, total, loss_dict and
  bn_updates), then the SGD step on the averaged gradients;
* SyncBN is ``all_reduce_mean`` of each BN's f32 batch statistics, with an
  autograd backward that all-reduces the cotangent
  (``models/layers.batch_norm_train``).  Training always syncs, as in
  glass_tpu: ``TPU.SYNC_BN`` and ``TPU.MESH_AXES`` are read nowhere there
  and nowhere here.

The step is held against glass_tpu explicitly, not through
``DistributedDataParallel``: DDP arms its reducer in ``DDP.forward``, and
the training forward calls the model's submodules
(``train.train_step.glass_train_forward``), not ``model.forward``.  A
plain all-reduce after the backward is glass_tpu's ``pmean(grads)``;
overlapping it with the backward is later work.

``make_parallel_train_scan`` is glass_tpu's K steps over K batches, the
Trainer's chunk of ``TPU.TRAIN_LOOP_STEPS``: a host loop over the step that
keeps the metrics on the device until it ends.  The step's own host syncs
(NMS fixpoints, the matcher's ``nonzero``) stay, so the chunk is not yet
one CUDA graph.  ``make_parallel_train_loop`` is glass_tpu's n steps on one
batch, the loop of the measurement tools (``tools/train_bench.py``,
``tools/train_mfu_breakdown.py``): a host loop too, not a CUDA graph.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import socket
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

# A collective that one rank never enters blocks the others until this
# timeout, then raises.
DEFAULT_TIMEOUT_S = 1800


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes of the ``torch.distributed`` group, 1 when there is none."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This process's rank in the group, 0 when there is none."""
    return dist.get_rank() if is_distributed() else 0


def multi_host() -> bool:
    """More ranks than this host runs (``torchrun`` sets LOCAL_WORLD_SIZE)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size())) < world_size()


def rank_device(device, local_rank: int) -> torch.device:
    """``cuda`` without an index is ``cuda:<local rank>``; an explicit
    device (``cuda:0`` for ranks sharing one card, ``cpu``) stays."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return dev


def init_process_group(rank_: int, world: int, device, init_method: str = "env://",
                       backend: Optional[str] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join a group: NCCL on CUDA, gloo on the CPU (or ``backend``).  Sets
    the rank's CUDA device first, as NCCL needs.  Returns the device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank_,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=dev if backend == "nccl" else None)
    return dev


def init_from_env(device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the group ``torchrun`` describes in the environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): glass_tpu's
    ``jax.distributed.initialize()`` for ``--distributed``.  The device is
    ``cuda:LOCAL_RANK`` unless ``device`` names another."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed joins a torchrun-style group from the environment, but {missing} "
            "are not set; launch with torchrun, or set them")
    r, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", r)))
    return init_process_group(r, world, dev, "env://", timeout_s=timeout_s)


def destroy() -> None:
    if is_distributed():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost for a spawned group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank_: int, world: int, init_method: str, backend, device, timeout_s, threads,
           worker: Callable, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    init_process_group(rank_, world, rank_device(device, rank_), init_method, backend, timeout_s)
    try:
        worker(*args)
    finally:
        destroy()


def launch(worker: Callable, world: int, args: tuple = (), device="cuda",
           init_method: Optional[str] = None, backend: Optional[str] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S, deadline_s: Optional[float] = None,
           threads: Optional[int] = None) -> None:
    """Run ``worker(*args)`` in ``world`` spawned processes, one per rank,
    each in the group first (``rank()`` and ``world_size()`` tell it which
    it is).  ``device`` ``cuda`` gives rank r ``cuda:r``; an explicit
    device is every rank's.  The rendezvous is ``init_method`` (default a
    free localhost TCP port).  Waits for every rank: when one fails, or
    ``deadline_s`` passes, the others are killed and this raises.
    ``worker`` and ``args`` are pickled (a module-level function)."""
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, daemon=False,
                         args=(r, world, init_method, backend, device, timeout_s, threads, worker, args))
             for r in range(world)]
    for p in procs:
        p.start()
    t0 = time.monotonic()
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0][0]} exited with code {bad[0][1]}"
                break
            if deadline_s is not None and time.monotonic() - t0 > deadline_s:
                failed = f"ranks still running after the {deadline_s:.0f} s deadline"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if failed is None and bad:
        failed = f"rank {bad[0][0]} exited with code {bad[0][1]}"
    if failed:
        raise RuntimeError(f"launch of {world} ranks failed: {failed}")


def shard_batch(batch: dict, rank_: Optional[int] = None, world: Optional[int] = None) -> dict:
    """A rank's rows of a global host batch: rows ``[r*b/w, (r+1)*b/w)``,
    the slice glass_tpu's mesh places on device r.  The identity with one
    process."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world
    if w == 1:
        return batch
    b = len(batch["images"])
    if b % w:
        raise ValueError(f"a batch of {b} rows does not split over {w} ranks")
    k = b // w
    return {key: v[r * k:(r + 1) * k] for key, v in batch.items()}


def collective_device(group=None) -> torch.device:
    """Where a collective's tensors live: the current CUDA device under
    NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree_batch_shape(batch: dict, group=None) -> dict:
    """Pad a rank's host batch to the image size of the global batch (an
    all-reduce max of the ranks' padded sizes; the max of the /32
    roundings is the rounding of the max), so each rank's shard is what
    glass_tpu's mesh gives one device of one padded global batch.  Padding
    is zero, as the loader's."""
    from ..data.loader import pad_batch_images

    hw = torch.tensor(batch["images"].shape[1:3], dtype=torch.int64, device=collective_device(group))
    dist.all_reduce(hw, op=dist.ReduceOp.MAX, group=group)
    return pad_batch_images(batch, tuple(int(v) for v in hw.cpu()))


class _AllReduceMean(torch.autograd.Function):
    """mean over ranks; the backward all-reduces the cotangent and divides
    by the world size (the transpose of glass_tpu's ``pmean`` under
    ``shard_map``: each rank's statistics take the summed cotangent of
    every rank's use of the mean)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable mean of ``x`` over the group's ranks (``pmean``)."""
    return _AllReduceMean.apply(x, group)


@contextlib.contextmanager
def sync_batch_norm(model: torch.nn.Module, group):
    """SyncBN over ``group`` inside the block (every BN's
    ``process_group``, glass_tpu's ``Ctx.axis_name``); per-process BN after
    it (serving, PreciseBN).  A one-rank group takes the per-process path."""
    from ..models.context import BatchNorm2d

    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.process_group = group if dist.get_world_size(group) > 1 else None
    try:
        yield
    finally:
        for m in bns:
            m.process_group = None


def _flat_all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> None:
    """One all-reduce of every tensor (one flat f32 buffer), each
    overwritten by its mean over the ranks."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def make_parallel_train_step(group=None) -> Callable:
    """glass_tpu's ``make_parallel_train_step`` over ``group``: returns
    ``step(model, optimizer, tcfg, batch, priorities, iteration)`` with the
    signature and result of ``train.train_step.train_step``.

    Per rank: the training forward on its shard with SyncBN, the
    backward, then one flat all-reduce mean of the gradients, the BN
    running statistics (each rank's EMA update with the synced statistics,
    glass_tpu's ``pmean(bn_updates)``), ``total`` and every loss and
    metric; then the SGD step on the averaged gradients.  A parameter the
    loss does not reach takes a zero gradient, as in the optimizer."""
    from ..models.context import BatchNorm2d
    from ..train.train_step import glass_train_forward
    from ..utils import trace

    def step(model, optimizer, tcfg, batch, priorities, iteration) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        with sync_batch_norm(model, group):
            total, losses = glass_train_forward(model, tcfg, batch, priorities)
            with trace.span("glass.backward"):
                total.backward()
        with trace.span("glass.all_reduce"), torch.no_grad():
            params = list(model.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            stats = [b for m in model.modules() if isinstance(m, BatchNorm2d)
                     for b in (m.running_mean, m.running_var)]
            names = sorted(losses)
            scalars = torch.stack([total.detach().to(torch.float32)]
                                  + [losses[k].detach().to(torch.float32) for k in names])
            _flat_all_reduce_mean([p.grad for p in params] + stats + [scalars], group)
        with trace.span("glass.optimizer"):
            optimizer.step(iteration)
        metrics = dict(zip(names, scalars[1:]))
        metrics["total_loss"] = scalars[0]
        return metrics

    return step


def make_parallel_train_scan(step: Callable) -> Callable:
    """glass_tpu's ``make_parallel_train_scan``: ``scan(model, optimizer,
    tcfg, batches, priorities, iterations)`` runs one ``step`` (the
    signature of ``train.train_step.train_step``, or a
    ``make_parallel_train_step`` result) per batch of ``batches``, step j at
    ``iterations[j]`` with ``priorities[j]`` (the caller folds the global
    iteration in, as glass_tpu folds it into each step's key, so the stream
    is the one-step loop's).  Returns every metric stacked (K,) on the
    device: nothing is read back until the chunk ends."""

    def scan(model, optimizer, tcfg, batches, priorities, iterations) -> Dict[str, torch.Tensor]:
        ms = [step(model, optimizer, tcfg, b, p, it) for b, p, it in zip(batches, priorities, iterations)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return scan


def make_parallel_train_loop(step: Callable, n_steps: int) -> Callable:
    """glass_tpu's ``make_parallel_train_loop``: ``loop(model, optimizer,
    tcfg, batch, priorities, iteration=0)`` runs ``n_steps`` consecutive
    ``step`` calls (the signature of ``train.train_step.train_step``, or a
    ``make_parallel_train_step`` result) on the one ``batch``.  Step i runs
    at ``iteration + i`` with ``priorities(i)``, the port's counterpart of
    glass_tpu's ``fold_in(key, i)``.  Nothing is read back: the last step's
    metrics come back on the device, as glass_tpu's ``fori_loop`` carry
    returns them."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be at least 1, got {n_steps}")

    def loop(model, optimizer, tcfg, batch, priorities: Callable, iteration: int = 0) -> Dict[str, torch.Tensor]:
        for i in range(n_steps):
            metrics = step(model, optimizer, tcfg, batch, priorities(i), iteration + i)
        return metrics

    return loop


def broadcast_state_(module: torch.nn.Module, src: int = 0, group=None) -> None:
    """Every rank takes rank ``src``'s parameters and buffers (DDP's rule
    at construction; it covers ``MODEL.WEIGHTS`` read on rank 0 alone)."""
    dev = collective_device(group)
    with torch.no_grad():
        for t in module.state_dict().values():
            buf = t.to(dev)
            dist.broadcast(buf, src, group=group)
            if buf is not t:
                t.copy_(buf)


def replicas_agree(tensors: Iterable[torch.Tensor], group=None) -> bool:
    """True when every rank holds the same bytes in ``tensors``: the
    bytewise max over the ranks equals the min."""
    dev = collective_device(group)
    raw = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8).to(dev) for t in tensors])
    hi, lo = raw.clone(), raw.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return bool(torch.equal(hi, lo))
