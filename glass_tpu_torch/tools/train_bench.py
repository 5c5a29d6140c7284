"""The pinned training-step benchmark of the port: the counterpart of
``tools/train_bench.py``.

The setting is ``configs/glass_pretrain.yaml`` at b = 1 on one
1024x1024 image, full losses (mask rasterization, the recognizer's teacher
forcing) and G = 24 real words in ``TPU.MAX_GT_INSTANCES`` slots
(``make_batch``, glass_tpu's numpy batch from the same seed).  The
optimizer is SGD with lr 1e-3 and momentum 0.9 (optax's ``sgd(1e-3,
momentum=0.9)``: no weight decay, no clipping, no schedule).

Windows of ``steps`` steps run through ``parallel.mesh.make_parallel_train_loop``
on the one batch; each starts from the same weights and optimizer state,
as glass_tpu's loop is fed the same arrays each window, and ends in a
synchronize; ms/step is the best window's.  glass_tpu's two forms (one
jitted ``fori_loop`` against steps dispatched one by one) coincide here:
``make_parallel_train_loop`` is itself the host loop of ``steps`` calls
with the last loss read once, so ``--dispatched`` is an alias that says
so and runs the same loop.

Usage: python -m glass_tpu_torch.tools.train_bench [--gts N] [--batch B]
    [--steps K] [--size S] [--windows W] [--dispatched] [--device cuda]
    [--opts KEY VALUE ...]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time

import numpy as np
import torch

from ..config import get_cfg
from ..models import GlassArch, GlassRCNN
from ..ops.boxes import boxes_to_polygons
from ..parallel.mesh import make_parallel_train_loop
from ..train.optimizer import build_optimizer
from ..train.train_step import Priorities, TrainConfig, batch_to_device, train_step
from ..train.trainer import init_weights_
from . import common

# optax.sgd(1e-3, momentum=0.9) through the port's optimizer
SGD_OPTS = ["SOLVER.BASE_LR", "0.001", "SOLVER.MOMENTUM", "0.9", "SOLVER.NESTEROV", "False",
            "SOLVER.WEIGHT_DECAY", "0.0", "SOLVER.WEIGHT_DECAY_NORM", "0.0", "SOLVER.WARMUP_ITERS", "0",
            "SOLVER.STEPS", "()", "SOLVER.CLIP_GRADIENTS.ENABLED", "False"]
PRIORITY_SEED = 1


def make_batch(b, h, w, g_real, g_cap, max_word_len, seed=0):
    """glass_tpu's benchmark batch, array for array: b noise images, g_cap
    rotated word boxes per image of which the first g_real are valid, five
    random characters a word, the boxes' corners as 16-vertex polygons."""
    rng = np.random.RandomState(seed)
    boxes = np.stack(
        [
            rng.uniform(64, w - 64, (b, g_cap)),
            rng.uniform(64, h - 64, (b, g_cap)),
            rng.uniform(24, 180, (b, g_cap)),
            rng.uniform(10, 40, (b, g_cap)),
            rng.uniform(-60, 60, (b, g_cap)),
        ],
        axis=-1,
    ).astype(np.float32)
    valid = np.zeros((b, g_cap), bool)
    valid[:, :g_real] = True
    text = np.zeros((b, g_cap, max_word_len + 2), np.int64)
    text[..., 1:6] = rng.randint(1, 60, (b, g_cap, 5))
    text[..., 6] = 0
    polys4 = boxes_to_polygons(torch.from_numpy(boxes)).numpy()
    k = 16
    polys = np.zeros((b, g_cap, k, 2), np.float32)
    polys[:, :, :4] = polys4
    return {
        "images": (rng.rand(b, h, w, 3) * 255).astype(np.float32),
        "content_hw": np.tile([[h, w]], (b, 1)).astype(np.int32),
        "gt_boxes": boxes,
        "gt_valid": valid,
        "gt_classes": np.zeros((b, g_cap), np.int32),
        "gt_orientation": rng.randint(0, 4, (b, g_cap)).astype(np.int32),
        "gt_text": text,
        "gt_polygons": polys,
        "gt_poly_nv": np.full((b, g_cap), 4, np.int32),
    }


def build(gts=24, batch=1, size=1024, opts=(), device=None):
    """The benchmark's model, optimizer and batch on the device, without
    timing: the MFU tools warm every variant first and then time them in
    turns in one process."""
    dev = common.setup(device)
    cfg = get_cfg(common.PRETRAIN, list(opts))
    arch = GlassArch.from_config(cfg)
    tcfg = TrainConfig.from_config(cfg)
    model = init_weights_(GlassRCNN(arch), 0).to(dev)
    optimizer = build_optimizer(get_cfg(common.PRETRAIN, [*opts, *SGD_OPTS]), model)
    data = make_batch(batch, size, size, gts, cfg.TPU.MAX_GT_INSTANCES, arch.max_word_len)
    return dict(cfg=cfg, arch=arch, tcfg=tcfg, model=model, optimizer=optimizer,
                data=batch_to_device(data, dev), batch=batch, device=dev)


def priorities_from(device, base: int = 0):
    """Step i's priorities: the seed folds the window (``base``) and i."""
    return lambda i: Priorities(PRIORITY_SEED, base + i, device)


def snapshot(built) -> tuple:
    """The weights and optimizer state, to start each window from."""
    return (copy.deepcopy(built["model"].state_dict()), copy.deepcopy(built["optimizer"].state_dict()))


def restore(built, state) -> None:
    built["model"].load_state_dict(state[0])
    built["optimizer"].load_state_dict(state[1])


def step_flops(built) -> int:
    """``FlopCounterMode``'s count of one training step (forward, backward
    and the update), from a snapshot that is restored after it."""
    state = snapshot(built)
    flops = common.count_flops(lambda: train_step(
        built["model"], built["optimizer"], built["tcfg"], built["data"],
        Priorities(PRIORITY_SEED, 0, built["device"]), 0))
    restore(built, state)
    return flops


def measure(gts=24, batch=1, steps=10, size=1024, opts=(), with_flops=False, windows=1, device=None):
    """Run the benchmark; returns a result dict.  ``with_flops`` adds the
    step's count and its MFU (on the card)."""
    built = build(gts, batch, size, opts, device)
    dev, cfg = built["device"], built["cfg"]
    args = (built["model"], built["optimizer"], built["tcfg"], built["data"])
    flops = step_flops(built) if with_flops else None
    loop = make_parallel_train_loop(train_step, steps)
    state = snapshot(built)
    loss = float(loop(*args, priorities_from(dev))["total_loss"])  # warm-up
    window_ms = []
    for w in range(max(1, windows)):
        restore(built, state)
        common.sync(dev)
        t0 = time.perf_counter()
        metrics = loop(*args, priorities_from(dev, (7 + w) * steps))
        loss = float(metrics["total_loss"])  # the one read-back, after the last step
        window_ms.append((time.perf_counter() - t0) / steps * 1e3)
    ms = min(window_ms)
    return {
        "device": common.device_info(dev),
        "ms_per_step": ms,
        "window_ms_per_step": window_ms,
        "ips_per_chip": batch / (ms / 1e3),
        "batch": batch, "size": size, "gts": gts, "steps": steps,
        "loop": "make_parallel_train_loop",
        "compute_dtype": cfg.TPU.COMPUTE_DTYPE,
        "last_total_loss": loss,
        "match_backend": cfg.TPU.MATCH_BACKEND,
        "rpn_sampler": cfg.TPU.RPN_SAMPLER,
        "flops": flops,
        "mfu": common.mfu(flops, ms, dev, cfg.TPU.COMPUTE_DTYPE),
        "host_loadavg_1m": os.getloadavg()[0],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gts", type=int, default=24)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--windows", type=int, default=1)
    ap.add_argument("--opts", nargs="*", default=[])
    ap.add_argument("--dispatched", action="store_true",
                    help="glass_tpu's per-step form: the same host loop here (an alias)")
    ap.add_argument("--flops", action="store_true", help="count the step's FLOPs and its MFU")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.dispatched:
        print("train_bench: --dispatched runs make_parallel_train_loop, which already dispatches "
              "the steps one by one from the host", file=sys.stderr, flush=True)
    return common.emit(measure(args.gts, args.batch, args.steps, args.size, args.opts,
                               with_flops=args.flops, windows=args.windows, device=args.device))


if __name__ == "__main__":
    main()
