"""One run of one cell of the benchmark of ``glass_tpu_torch`` on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is resolved by name from
``BENCHMARK.json`` (``harness/spec.py``); its traffic file names the loop
(``harness/loops.py``).  The run makes its weights and inputs from the
seed, warms up the cell's shapes (set-up), measures for ``--seconds``,
then compares what the timed path produced with the plain reference
(``correct``).  With ``--trace 1`` the first units of the window run under
``torch.profiler`` and the line carries the cell's per-layer metrics
instead of its end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number beside its limit); the
last lines of standard error give the compared numbers too.  The run exits
non-zero, with no result, when there is no CUDA device or fewer cards than
the cell asks for, and when ``jax``, ``jaxlib``, ``flax`` or ``glass_tpu``
is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "glass_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = ".bench_cache"


def set_caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only the first run of a cell there builds."""
    base = os.path.join(root, CACHE)
    os.environ["GLASS_TPU_TORCH_BUILD_DIR"] = os.path.join(base, "glass_build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def few_threads() -> None:
    """One process with one thread of each library's pool (OpenMP, BLAS,
    PyTorch's intra-op pool, OpenCV): the card's host shares its cores, and
    idle pools that spin on them made the host-bound cells' runs spread by
    10-13 %.  Set before the libraries are loaded."""
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = "1"


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one the benchmark may not
    load, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, opts=(), mix_overrides=None, root=ROOT) -> int:
    """Run one cell; returns the exit code.  ``device``, ``opts`` and
    ``mix_overrides`` are for the CPU tests alone (a tiny size on the CPU,
    where every device metric is null)."""
    args = parse(argv)
    set_caches(root)
    if device is None:
        few_threads()
    import torch

    from benchmark.harness import judge
    from benchmark.harness.loops import LOOPS
    from benchmark.harness.spec import Cell, load_spec

    cell = Cell(load_spec(root), args.workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.set_num_threads(1)
        import cv2

        cv2.setNumThreads(1)
    else:
        dev = torch.device(device)
    mix = dict(cell.traffic)
    mix.update(mix_overrides or {})
    res = LOOPS[mix["loop"]](cell, args.seed, args.seconds, bool(args.trace), dev, T_START,
                                 list(mix.get("opts", [])) + list(opts), mix)

    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded {found}, which the benchmark may not load", file=sys.stderr)
        return 3

    on_card = dev.type == "cuda"
    correct, lines = judge.verdict(res.numbers, cell.limits)
    metrics = {}
    if not args.trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                v = res.setup_s
            elif m["name"] == "peak_mem_gib":
                v = None if res.peak_bytes is None else res.peak_bytes / 2 ** 30
            else:
                v = res.e2e.get(m["name"])
            metrics[m["name"]] = {"value": v if on_card else None, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cell.reader(m["name"])(res.reading) if on_card else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if on_card:
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell.chips,
                       "memory_peak_bytes": res.peak_bytes, "power_limit": _power_limit()}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    result = {"correct": bool(correct), "attempted": res.reading.window_units, "failed": 0,
              "metrics": metrics, "device": device_info}
    if args.trace and on_card and res.reading.trace is not None:
        tr = res.reading.trace
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["compared"] = {k: {"value": _finite(res.numbers.get(k)), "limit": v} for k, v in cell.limits.items()}
    for note in res.notes:
        print(f"benchmark: {note}", file=sys.stderr)
    print(f"benchmark: setup_s {res.setup_s:.3f}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _finite(v):
    """A compared number for the JSON line: None where it is not finite."""
    return v if v is None or math.isfinite(v) else None


def _power_limit():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())
