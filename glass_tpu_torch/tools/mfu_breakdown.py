"""Per-stage MFU of the serving frame and of the training step: the
counterpart of ``tools/mfu_breakdown.py``.

MFU = the stage's FLOPs / its time / the card's published peak for the
stage's compute dtype (``common.PEAK_TFLOPS``: 989 TFLOP/s for bf16 and
fp16 on an H100; an unknown card raises).  The FLOPs are
``FlopCounterMode``'s count over one call of the stage (convolutions and
matmuls from their shapes; the hand kernels' work is bounded in PERF.md's
kernel table, not counted here).  The serving stages are
``profile_breakdown``'s, timed as its rows are; the training row is
``train_bench.measure`` with its step's count.

Usage: python -m glass_tpu_torch.tools.mfu_breakdown [serve] [train]
    [--k 30] [--steps 10] [--device cuda] [--hw H W] [--opts ...]
    [--train-size S] [--train-opts ...]
Prints one line a stage, then one JSON line.
"""

from __future__ import annotations

import argparse

import torch

from . import common, profile_breakdown as pb, train_bench

SERVE_STAGES = [
    ("backbone_fpn", "stage_backbone"),
    ("detect(rpn+box+nms)", "stage_detect"),
    ("recognizer(crop+fuse+read)", "stage_recognize"),
    ("mask_head", "stage_mask"),
    ("e2e_serve_frame", "stage_full"),
]


def _row(stage, ms, flops, device, dtype) -> dict:
    mfu = common.mfu(flops, ms, device, dtype)
    print(f"{stage:30s} {ms:9.3f} ms  {flops / 1e9:9.2f} GFLOP  MFU "
          f"{'-' if mfu is None else f'{100 * mfu:.2f}%'}", flush=True)
    return {"stage": stage, "ms": ms, "gflops": flops / 1e9, "mfu": mfu}


def run_serve(k=30, device=None, hw=pb.PAD_HW, opts=()) -> list:
    state = pb.model_state(device, hw, opts)
    dev, dtype = state["device"], state["arch"].compute_dtype
    rows = []
    for stage, row in SERVE_STAGES:
        with torch.inference_mode():
            fn = pb.ROWS[row](state)
            fn()  # warm-up
            flops = common.count_flops(fn)
            ms = common.event_ms(fn, dev, k)
        rows.append(_row(stage, ms, flops, dev, dtype))
    return rows


def run_train(steps=10, device=None, size=1024, opts=()) -> list:
    tr = train_bench.measure(steps=steps, size=size, opts=opts, with_flops=True, device=device)
    dev = common.setup(device)
    return [_row("train_step", tr["ms_per_step"], tr["flops"], dev, tr["compute_dtype"])]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("what", nargs="*", default=[], help="serve and/or train (default both)")
    ap.add_argument("--k", type=int, default=30, help="timed calls a serving stage")
    ap.add_argument("--steps", type=int, default=10, help="training steps a window")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--hw", type=int, nargs=2, default=pb.PAD_HW, metavar=("H", "W"))
    ap.add_argument("--opts", nargs="*", default=[], help="serving config overrides")
    ap.add_argument("--train-size", type=int, default=1024)
    ap.add_argument("--train-opts", nargs="*", default=[], help="training config overrides")
    args = ap.parse_args(argv)
    what = args.what or ["serve", "train"]
    unknown = set(what) - {"serve", "train"}
    if unknown:
        raise SystemExit(f"unknown tables {sorted(unknown)}: expected serve and/or train")
    rows = []
    if "serve" in what:
        rows += run_serve(args.k, args.device, tuple(args.hw), args.opts)
    if "train" in what:
        rows += run_train(args.steps, args.device, args.train_size, args.train_opts)
    return common.emit({"device": common.device_info(common.setup(args.device)), "mfu_table": rows})


if __name__ == "__main__":
    main()
