"""Per-stage table of the port's training step: the counterpart of
``tools/train_mfu_breakdown.py``.

* Knockouts: the whole step of ``train_bench`` measured again with one
  branch turned off by the config; the difference is that branch's cost
  in context (its forward, backward and share of the update):
    - ``MODEL.BACKBONE.FREEZE_AT 5``: no ResNet backward;
    - ``MODEL.MASK_ON False``: no mask branch;
    - ``MODEL.RECOGNIZER_ON False``: no recognizer branch.
  Every variant is built and warmed first, then the variants are timed in
  turns, ``--trials`` rounds in one process, and each row is the median.
* Standalone: the backbone's training-mode forward and the SGD update, to
  split the freeze difference into forward and backward and bound the
  optimizer.

Each row's FLOPs are ``FlopCounterMode``'s counts (a knockout's: the
difference of two steps' counts) and its MFU is against the card's
published peak for the compute dtype (``common.PEAK_TFLOPS``).

Usage: python -m glass_tpu_torch.tools.train_mfu_breakdown [--steps 10]
    [--trials 3] [--size 1024] [--device cuda] [--extra-opts KEY VALUE ...]
Prints a table, then one JSON line.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..models import glass_rcnn as gr
from ..parallel.mesh import make_parallel_train_loop
from ..train.train_step import train_step
from . import common, train_bench

VARIANTS = [
    ("full", []),
    ("no_resnet_bwd(FREEZE_AT=5)", ["MODEL.BACKBONE.FREEZE_AT", "5"]),
    ("no_mask_branch", ["MODEL.MASK_ON", "False"]),
    ("no_recognizer_branch", ["MODEL.RECOGNIZER_ON", "False"]),
]


def prep_variant(opts, steps, size=1024, device=None) -> dict:
    """A variant's model, loop and starting state, warmed, with its step's
    FLOPs."""
    built = train_bench.build(size=size, opts=list(opts), device=device)
    loop = make_parallel_train_loop(train_step, steps)
    args = (built["model"], built["optimizer"], built["tcfg"], built["data"])
    state = train_bench.snapshot(built)
    float(loop(*args, train_bench.priorities_from(built["device"]))["total_loss"])  # warm-up
    flops = train_bench.step_flops(built)
    return dict(built=built, loop=loop, args=args, state=state, flops=flops, steps=steps)


def time_variant(v) -> float:
    """ms a step of one window from the variant's starting state."""
    train_bench.restore(v["built"], v["state"])
    dev = v["built"]["device"]
    common.sync(dev)
    t0 = time.perf_counter()
    float(v["loop"](*v["args"], train_bench.priorities_from(dev, 7 * v["steps"]))["total_loss"])
    return (time.perf_counter() - t0) / v["steps"] * 1e3


def standalone_stages(built, k=10) -> tuple:
    """(backbone training forward ms, its FLOPs, SGD update ms), each over
    ``k`` calls; the weights and optimizer state are restored after."""
    model, opt, dev = built["model"], built["optimizer"], built["device"]
    state = train_bench.snapshot(built)
    model.train()
    image = built["data"]["images"][:1]

    def backbone():
        return gr.backbone_features(model, gr.preprocess(model, image))

    with torch.no_grad():
        bb_ms = common.event_ms(backbone, dev, k)
        bb_flops = common.count_flops(backbone)
        for p in model.parameters():
            p.grad = p * 1e-3
    opt_ms = common.event_ms(lambda: opt.step(0), dev, k)
    train_bench.restore(built, state)
    return bb_ms, bb_flops, opt_ms


def run(steps=10, trials=3, size=1024, device=None, extra_opts=()) -> dict:
    variants = [(name, list(extra_opts) + opts) for name, opts in VARIANTS]
    prepped = {}
    for name, opts in variants:
        prepped[name] = prep_variant(opts, steps, size, device)
        print(f"  warmed {name}", flush=True)
    times = {name: [] for name, _ in variants}
    for trial in range(trials):
        for name, _ in variants:
            times[name].append(time_variant(prepped[name]))
        print(f"  trial {trial}: " + "  ".join(f"{n}={times[n][-1]:.1f}ms" for n, _ in variants), flush=True)
    med = {n: sorted(ts)[len(ts) // 2] for n, ts in times.items()}
    flops = {n: prepped[n]["flops"] for n, _ in variants}
    full = prepped["full"]["built"]
    dev, dtype = full["device"], full["cfg"].TPU.COMPUTE_DTYPE
    bb_ms, bb_flops, opt_ms = standalone_stages(full)

    rows = []

    def row(stage, ms, fl):
        rows.append({"stage": stage, "ms": ms, "gflops": None if fl is None else fl / 1e9,
                     "mfu": common.mfu(fl, ms, dev, dtype) if ms > 0 else None})

    row("full_step", med["full"], flops["full"])
    for name, _ in variants[1:]:
        row(f"Δ {name}", med["full"] - med[name], flops["full"] - flops[name])
    row("backbone_fwd(standalone)", bb_ms, bb_flops)
    frz = "no_resnet_bwd(FREEZE_AT=5)"
    row("resnet_bwd(=freeze Δ)", med["full"] - med[frz], flops["full"] - flops[frz])
    row("sgd_update(standalone)", opt_ms, None)
    rest = (med[frz] - bb_ms - opt_ms - (med["full"] - med["no_mask_branch"])
            - (med["full"] - med["no_recognizer_branch"]))
    row("rpn+matcher+box+sampling(remainder)", rest, None)
    print(f"\n== train step stage table (b=1, {size}x{size}, G=24) ==")
    for r in rows:
        g = "-" if r["gflops"] is None else f"{r['gflops']:.1f}"
        m = "-" if r["mfu"] is None else f"{100 * r['mfu']:.2f}%"
        print(f"{r['stage']:38s} {r['ms']:9.2f} ms  {g:>9s} GFLOP  MFU {m}", flush=True)
    return {"device": common.device_info(dev), "size": size, "steps": steps, "trials": trials,
            "train_mfu_table": rows, "medians_ms": med}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--extra-opts", nargs="*", default=[], help="config overrides of every variant")
    args = ap.parse_args(argv)
    return common.emit(run(args.steps, args.trials, args.size, args.device, args.extra_opts))


if __name__ == "__main__":
    main()
