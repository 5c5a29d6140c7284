"""What the port's measurement tools share: the benchmark configuration,
the card's identity, the clocks, the FLOP count and the peak table.

Every tool runs on ``cuda`` unless ``--device cpu`` is given
(``device.resolve_device``: asking for the card on a machine without one
raises).  A CPU run says so in its ``device`` entry, and the numbers that
only a card can give (device time, MFU, device busy share) are ``None``
there: a CPU time is never written under a device metric's name.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Callable, Optional, Sequence

import torch

from ..config import CfgNode, get_cfg
from ..device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ICDAR15 = os.path.join(REPO, "configs", "glass_finetune_icdar15.yaml")
PRETRAIN = os.path.join(REPO, "configs", "glass_pretrain.yaml")

# Published dense peaks of one card (NVIDIA's data sheet, SXM part, at its
# full power limit), TFLOP/s, by the compute type of a stage's convolutions
# and matmuls.  Keyed on a substring of ``torch.cuda.get_device_name``.
PEAK_TFLOPS = {
    "H100": {"bfloat16": 989.0, "float16": 989.0, "tf32": 495.0, "float32": 67.0},
}


def peak_flops(card: str, compute_dtype: str) -> float:
    """The card's published peak FLOP/s for ``compute_dtype`` ("bfloat16",
    "float16", "tf32", "float32").  A card the table does not name raises."""
    for key, table in PEAK_TFLOPS.items():
        if key in card:
            return table[compute_dtype] * 1e12
    raise KeyError(f"no published peak for the card {card!r}; the table names {sorted(PEAK_TFLOPS)}")


def peak_dtype(compute_dtype: str) -> str:
    """The peak a stage of ``TPU.COMPUTE_DTYPE`` runs against: an f32 stage's
    convolutions run on TF32 when cuDNN is allowed it (PyTorch's default)."""
    if compute_dtype == "float32" and torch.backends.cudnn.allow_tf32:
        return "tf32"
    return compute_dtype


def bench_cfg(opts: Optional[Sequence[str]] = None) -> CfgNode:
    """The ICDAR15 eval configuration with bench.py's overrides: MIN/MAX
    test sizes 1000/1600, masks on, and every threshold 0, so that a random
    model fills all of its word slots and every stage runs at full load.
    Then ``GLASS_BENCH_OPTS`` (space-separated KEY VALUE pairs), then
    ``opts``."""
    cfg = get_cfg(ICDAR15)
    cfg.INPUT.MIN_SIZE_TEST = 1000
    cfg.INPUT.MAX_SIZE_TEST = 1600
    cfg.MODEL.ROI_MASK_HEAD.MASK_INFERENCE = True
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.POST_PROCESSING.TEXT_THRESHOLD = 0.0
    cfg.POST_PROCESSING.DETECT_THRESHOLD = 0.0
    cfg.POST_PROCESSING.VALID_CONFIDENCE = 0.0
    env = os.environ.get("GLASS_BENCH_OPTS", "").split()
    if env:
        cfg.merge_from_list(env)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


def card_power_limit() -> str:
    """``nvidia-smi``'s power limit of the first card, e.g. "700.00 W"."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_info(device: torch.device) -> dict:
    """What a result ran on: the card's name, count and power limit, or a
    CPU label."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "note": "a CPU run: no device metric is measured"}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "power_limit": card_power_limit()}


def setup(device) -> torch.device:
    """Resolve ``--device`` and make it current."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn: Callable, device: torch.device) -> float:
    """Host clock around one call of ``fn``, ending in a synchronize."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3


def event_ms(fn: Callable, device: torch.device, iters: int, warmup: int = 2) -> float:
    """Mean ms of a call of ``fn`` over ``iters`` back-to-back calls after
    ``warmup``: between two CUDA events on the card (the device time plus
    the host work it could not hide), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / iters


def device_busy_ms(fn: Callable, device: torch.device) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall ms (ending in a
    synchronize), the device time of its kernels and copies, their count
    and the busy share.  ``None`` values on the CPU.  The trace can miss a
    kernel (on the H100, a call of one cuDNN convolution read 0 ms:
    ``study/clock_witness.py``), so a short call is timed by ``graph_ms``."""
    if device.type != "cuda":
        fn()
        return {"wall_ms": None, "device_ms": None, "device_records": None, "busy_share": None}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    # the profiler's own buffer requests and the device copies of the
    # record_function spans are not device work
    def work(name):
        return name != "Activity Buffer Request" and not name.startswith("glass.")

    dev = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", None)) and work(e.key)) / 1e3
    records = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and work(e.name))
    return {"wall_ms": wall, "device_ms": dev, "device_records": records, "busy_share": dev / wall}


def graph_ms(fn: Callable, device: torch.device, iters: int) -> Optional[float]:
    """The card's ms of one call of ``fn`` without the host's dispatch: the
    call captured in a CUDA graph (after two calls on a side stream) and
    replayed ``iters`` times between two CUDA events.  ``fn`` must not
    synchronize with the host.  ``None`` on the CPU."""
    if device.type != "cuda":
        return None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / iters


def count_flops(fn: Callable) -> int:
    """The FLOPs PyTorch's ``FlopCounterMode`` counts in one call of ``fn``:
    convolutions and matmuls from their shapes (2 per multiply-add), the
    backward's too when ``fn`` runs it.  The hand kernels' work is not
    counted (PERF.md's kernel table bounds it)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def mfu(flops: Optional[float], ms: float, device: torch.device, compute_dtype: str) -> Optional[float]:
    """FLOPs over the time over the card's peak; ``None`` on the CPU."""
    if device.type != "cuda" or not flops:
        return None
    return flops / (ms / 1e3) / peak_flops(torch.cuda.get_device_name(device), peak_dtype(compute_dtype))


def emit(result: dict) -> dict:
    """Print ``result`` as one JSON line and return it."""
    print(json.dumps(result), flush=True)
    return result
