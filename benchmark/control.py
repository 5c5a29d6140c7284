"""The control of a cell's comparison: the plain reference put in the
program's place, computed one precision below what the configuration
states (every convolution, product and recurrence on float8 e4m3 operands,
forward and backward, for the configuration's bfloat16), set up and judged
by the loops' own functions (``harness/loops.py``).  It has to
come out as not correct; its readings are the upper ends of the limits.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...]

prints one JSON line per seed with the numbers, and the verdict against
the cell's limits.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_serving(cell, seed, dev, opts, mix, path):
    """The serving control: the loop's own inputs and judge, with the
    reference's runner at the control's precision in the program's place,
    on the answers a run compares."""
    import torch

    from benchmark.harness import loops, traffic
    from benchmark.harness.capture import Capture
    from benchmark.reference import runner as ref_runner_mod
    from benchmark.reference.glass.models import glass_rcnn, layers, rpn
    from benchmark.reference.runner import RefRunner, build_model

    rcfg, pool, sd, _ = loops.serving_inputs(cell, seed, dev, opts, mix)
    among = int(mix["images_per_call"] if path == "eval" else mix["compare_among"])
    sample = traffic.sample(seed, among, int(mix["compare"]))
    images = [pool[i % len(pool)] for i in sample]
    with loops.reference_precision(), torch.no_grad():
        rr = RefRunner(rcfg, build_model(rcfg, sd, dev), dev)
        cap = Capture(ref_runner_mod, glass_rcnn, rpn, rr.model, wanted=range(len(sample))).install()
        try:
            with layers.control_precision():
                returned = [rr.eval_image(im) if path == "eval" else rr.serve_image(im) for im in images]
        finally:
            cap.finish()
            cap.remove()
    del rr
    loops.free()
    return loops.judge_serving(rcfg, {k: v.cpu() for k, v in sd.items()}, dev, path, images, cap.kept,
                               dict(enumerate(returned)), range(len(images)), lambda k: k)


def control_training(cell, seed, dev, opts, mix):
    """The training control: the loop's own inputs and judge, with the
    reference's checked steps at the control's precision (its own
    selection, recorded) in the program's place."""
    from benchmark.harness import loops
    from benchmark.harness.capture import StepRecorder
    from benchmark.reference import train as ref_train
    from benchmark.reference.glass.models import layers
    from benchmark.reference.glass.train import train_step as ref_ts

    rcfg, sd, host_batches, prior_seed = loops.training_inputs(cell, seed, dev, opts, mix)
    n = int(mix["checked_steps"])
    batches = [loops.reference_batch(x, dev) for x in host_batches[:n]]
    rec = StepRecorder(ref_ts).install()
    try:
        with loops.reference_precision(), layers.control_precision():
            ctl = ref_train.follow(rcfg, sd, batches, prior_seed, 0, [None] * n, dev)
    finally:
        rec.remove()
    numbers, ref = loops.judge_training(rcfg, sd, host_batches, prior_seed, rec.calls, ctl, mix, dev)
    numbers["losses"] = {"control": ctl["losses"], "reference": ref["losses"]}
    numbers["widest"] = {"grads": loops.worst_leaves(ctl, ref, "grads"),
                         "change": loops.worst_leaves(ctl, ref, "change"),
                         "groups": {"grads": loops.widest_groups(ctl, ref, "grads"),
                                    "change": loops.widest_groups(ctl, ref, "change")}}
    return numbers


def main(argv=None, device=None, opts=(), mix_overrides=None, root=ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from benchmark.run import set_caches

    set_caches(root)
    import torch

    from benchmark.harness import judge
    from benchmark.harness.spec import Cell, load_spec

    cell = Cell(load_spec(root), args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    mix = dict(cell.traffic)
    mix.update(mix_overrides or {})
    opts = list(mix.get("opts", [])) + list(opts)
    failed_all = True
    for seed in args.seeds:
        if mix["loop"] == "train_steps":
            numbers = control_training(cell, seed, dev, opts, mix)
        else:
            numbers = control_serving(cell, seed, dev, opts, mix,
                                      "eval" if mix["loop"] == "eval_batch" else "serve")
        correct, lines = judge.verdict(numbers, cell.limits)
        failed_all &= not correct
        for line in lines:
            print(f"control seed {seed}: {line}", file=sys.stderr)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": correct, "numbers": numbers}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
