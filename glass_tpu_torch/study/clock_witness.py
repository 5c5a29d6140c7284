"""Which clock reads a call's device time: the ResNet stages of
``tools.backbone_bwd_breakdown`` (stem, res2, res4 at 1024x1024, bf16,
training mode) and res4's last 3x3 convolution alone, each read by

* ``events``: ``k`` back-to-back calls between two CUDA events (the host's
  dispatch included where it is slower than the card);
* ``queued``: the same ``k`` calls queued behind a spin kernel
  (``torch.cuda._sleep``) long enough for the host to enqueue them all, so
  that the events time the card alone (``valid`` False if the spin ended
  before the host did);
* ``graph``: one call captured in a CUDA graph, replayed ``k`` times
  between events;
* ``prof1`` / ``prof_k``: ``torch.profiler``'s kernel time of one call /
  ``k`` calls in one trace; ``prof1_late``: one call, 20 ms after the trace
  starts; ``prof_sched``: one call in the active step of a
  ``schedule(warmup=1, active=1)``, read in ``on_trace_ready``.

    python3 -m glass_tpu_torch.study.clock_witness [--k 10]

on one GPU; prints a line a case and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..tools import backbone_bwd_breakdown as bb
from ..tools import common


def _kernel_ms(prof, calls):
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", None)) and e.key != "Activity Buffer Request"
                and not e.key.startswith("glass.") and "sleep" not in e.key.lower())
    return total / 1e3 / calls


def clocks(fn, k) -> dict:
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"events": common.event_ms(fn, torch.device("cuda"), k)}

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(max(out["events"], 1.0) * k * 3e6))  # ~1.5-3 GHz: cycles for 1-2x the host's time
    start.record()
    for _ in range(k):
        fn()
    stop.record()
    valid = not start.query()
    torch.cuda.synchronize()
    out["queued"], out["queued_valid"] = start.elapsed_time(stop) / k, valid

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(k):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    out["graph"] = start.elapsed_time(stop) / k
    del graph

    for name, calls, late in (("prof1", 1, 0.0), ("prof_k", k, 0.0), ("prof1_late", 1, 0.02)):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(late)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out[name] = _kernel_ms(prof, calls)

    seen = {}
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: seen.setdefault("ms", _kernel_ms(p, 1))) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    out["prof_sched"] = seen.get("ms")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--size", type=int, default=1024)
    args = ap.parse_args(argv)
    dev = common.setup("cuda")
    rows = []
    for name, module, shape in bb.stages(args.size, dev):
        if name not in ("stem", "res2", "res4"):
            continue
        x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last).requires_grad_(True)
        fwd, _, fwd_dx_dw, _ = bb._calls(module, x)
        cases = [(f"{name} fwd", fwd), (f"{name} fwd+dX+dW", fwd_dx_dw)]
        if name == bb.WITNESS:
            conv = module[-1].conv2
            with torch.no_grad():
                hw = module(x).shape[-2:]
            xw = torch.randn(1, conv.weight.shape[1], *hw, device=dev, dtype=torch.bfloat16)
            xw = xw.contiguous(memory_format=torch.channels_last)
            w16 = conv.weight.detach().to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

            def bare():
                with torch.no_grad():
                    return F.conv2d(xw, w16, None, 1, 1)

            cases.append((f"{name} last 3x3 conv alone", bare))
        for label, fn in cases:
            row = {"case": label, **clocks(fn, args.k)}
            rows.append(row)
            print(f"{label:28s} " + "  ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                            for k, v in row.items() if k != "case"), flush=True)
    res = {"device": common.device_info(dev), "k": args.k, "size": args.size, "rows": rows}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
