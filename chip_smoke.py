#!/usr/bin/env python3
"""Drive glass_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases 1,2,3

Phases:
  1. card and build: the card's name and power limit; build every CUDA
     kernel of the port from the sources in this checkout (one nvcc per
     source, started together).
  2. K1 (rotated RoIAlign, csrc/roi_align_rotated.cu) against its plain
     PyTorch version at the three poolers' main-path shapes (960x1600
     bucket, 100 rois, C=256), in float32 and bfloat16.
  3. K2 (raw-image crop, csrc/crop_rois.cu) likewise: a 960x1600 image in
     uint8 with the normalization folded in and normalized in f32/bf16,
     100 rois, sampling ratios 1, 2 and 0.
  4. the main path: GlassRunner on the ICDAR15 eval configuration (config +
     the eval protocol overrides), seeded random weights, bfloat16 compute,
     synthetic 720x1280 images through ``__call__``; the kernels' launch
     counters must rise during this phase.
  5. whole-path check: one full-size image through the port at float32
     (no TF32) on the card and on the CPU (plain versions), same weights.

Prints, on the last two lines, a JSON object with one entry per kernel and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
ICDAR15 = os.path.join("configs", "glass_finetune_icdar15.yaml")
BUCKET_HW = (960, 1600)
STRIDES = (4, 8, 16, 32, 64)
N_ROIS = 100
N_IMAGES = 8      # distinct synthetic main-path images
N_TIMED = 40      # timed main-path images, after 2 warm-up
STAGES = ("glass.backbone", "glass.rpn", "glass.box_head", "glass.recognizer", "glass.mask_head")

# K1 poolers on the main path: (name, output, sampling ratio, bulk grid, single level)
POOLERS = (
    ("box", (7, 7), 2, 2, False),
    ("mask", (14, 14), 0, (1, 2), False),
    ("recognizer", (8, 32), 0, (2, 1), True),
)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean over ``iters`` back-to-back calls between two CUDA events: the
    device time plus whatever host work between launches it could not hide."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` (one kernel launch), replayed
    from a CUDA graph of ``iters`` back-to-back calls: the wrapper's host
    work (checks, allocation, the ctypes call) runs once at capture and not
    between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(stop) / iters


# ---------------------------------------------------------------------------
# synthetic inputs
# ---------------------------------------------------------------------------


def word_rois(rng: np.random.RandomState, n: int, h: int, w: int) -> np.ndarray:
    """Word-like rotated boxes over an h x w image: elongated, rotated, some
    hanging over the edges, five far larger than any 48x56 tile of any level,
    and more than 16 whose adaptive grid exceeds the bulk grid."""
    cx = rng.uniform(-40, w + 40, n)
    cy = rng.uniform(-40, h + 40, n)
    bw = np.exp(rng.uniform(np.log(12), np.log(900), n))
    bh = np.exp(rng.uniform(np.log(8), np.log(140), n))
    ang = rng.uniform(-90, 90, n)
    ang[: n // 4] = 0.0
    rois = np.stack([cx, cy, bw, bh, ang], 1).astype(np.float32)
    rois[-5:, 2] = rng.uniform(3600, 4200, 5)
    rois[-5:, 3] = rng.uniform(2000, 3200, 5)
    return rois


def synthetic_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A BGR uint8 scene: smooth background, noise and rotated text lines."""
    import cv2

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        90 + 60 * np.sin(xx / (37 + 20 * c) + c) * np.cos(yy / (53 + 11 * c)) for c in range(3)
    ], -1)
    img += rng.randn(h, w, 3).astype(np.float32) * 12
    img = np.clip(img, 0, 255).astype(np.uint8)
    words = ["GLASS", "text", "spotting", "H100", "rotated", "RoIAlign", "kernel", "2015"]
    for _ in range(24):
        layer = np.zeros_like(img)
        word = words[rng.randint(len(words))]
        scale = rng.uniform(0.8, 3.0)
        org = (int(rng.uniform(0, w * 0.8)), int(rng.uniform(40, h - 10)))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        cv2.putText(layer, word, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, int(1 + scale * 2))
        m = cv2.getRotationMatrix2D(org, float(rng.uniform(-40, 40)), 1.0)
        layer = cv2.warpAffine(layer, m, (w, h))
        mask = layer.sum(-1) > 0
        img[mask] = layer[mask]
    return img


# ---------------------------------------------------------------------------
# bounds: bytes and operations the work needs on this run's data
# ---------------------------------------------------------------------------


def touched_rows(rows_meta, rois, levels, grid, out_hw) -> int:
    """Distinct feature rows the bilinear taps of in-bounds samples read."""
    from glass_tpu_torch.ops.roi_align_rotated import bilinear_plain

    ph_n, pw_n = out_hw
    m = rows_meta[levels.long()]
    scale, height, width, base = m[:, 0], m[:, 1], m[:, 2], m[:, 3].long()
    cx = rois[:, 0] * scale - 0.5
    cy = rois[:, 1] * scale - 0.5
    rw, rh = rois[:, 2] * scale, rois[:, 3] * scale
    th = rois[:, 4] * math.pi / 180.0
    c, s = torch.cos(th), torch.sin(th)
    g_h, g_w = grid[:, 0].float(), grid[:, 1].float()
    ph = torch.arange(ph_n, device=rois.device, dtype=torch.float32)
    pw = torch.arange(pw_n, device=rois.device, dtype=torch.float32)
    seen = []
    col = lambda t: t[:, None, None]  # noqa: E731
    for iy in range(int(grid[:, 0].max())):
        yy = (-rh[:, None] / 2.0 + ph[None] * (rh / ph_n)[:, None]) + ((iy + 0.5) * (rh / ph_n) / g_h)[:, None]
        for ix in range(int(grid[:, 1].max())):
            xx = (-rw[:, None] / 2.0 + pw[None] * (rw / pw_n)[:, None]) + ((ix + 0.5) * (rw / pw_n) / g_w)[:, None]
            y = (yy[:, :, None] * col(c) - xx[:, None, :] * col(s)) + col(cy)
            x = (yy[:, :, None] * col(s) + xx[:, None, :] * col(c)) + col(cx)
            (yi, xi, yi1, xi1), ws = bilinear_plain(y, x, col(height), col(width), 1.0)
            on = col((iy < grid[:, 0]) & (ix < grid[:, 1])) & ((ws[0] + ws[1] + ws[2] + ws[3]) > 0)
            wr, br = col(width.long()), col(base)
            for a, b in ((yi, xi), (yi, xi1), (yi1, xi), (yi1, xi1)):
                seen.append((br + a * wr + b)[on])
    return int(torch.unique(torch.cat(seen)).numel())


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build(out_dir):
    from glass_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    logs = _cuda.build_all()
    took = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "kernel_build.log"), "w") as f:
        for name, (sec, text) in logs.items():
            f.write(f"== {name} ({sec:.1f} s)\n{text}\n")
    for name, (sec, text) in logs.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"built {name} in {sec:.1f} s; {regs[-1] if regs else ''}")
    log(f"phase 1: kernels built in {took:.1f} s")
    return took


def _pyramid(rng, dtype):
    from glass_tpu_torch.ops.roi_align_rotated import pack_pyramid

    maps = [torch.from_numpy(rng.randn(BUCKET_HW[0] // s, BUCKET_HW[1] // s, 256).astype(np.float32))
            .cuda().to(dtype) for s in STRIDES]
    return maps, pack_pyramid(maps, [1.0 / s for s in STRIDES])


def pooler_inputs(name, rng, dtype, rois):
    """Packed features, levels and per-roi grid exactly as the model's
    pooler call builds them."""
    from glass_tpu_torch.ops import roi_align_rotated as ra

    _, out_hw, sr, bulk, single = next(p for p in POOLERS if p[0] == name)
    if single:
        fused = torch.from_numpy(rng.randn(BUCKET_HW[0] // 4, BUCKET_HW[1] // 4, 256)
                                 .astype(np.float32)).cuda().to(dtype)
        pyr = ra.pack_pyramid([fused], [0.25])
        levels = torch.zeros((rois.shape[0],), dtype=torch.int32, device="cuda")
    else:
        _, pyr = _pyramid(rng, dtype)
        levels = ra.assign_boxes_to_levels(rois, 2, 6)
    n_large = n_full = 0
    if sr > 0:
        grid = ra.fixed_grid(rois.shape[0], sr, "cuda")
    else:
        rh, rw = ra._scaled_extent(rois, pyr.meta, levels)
        grid = ra.split_grid(rh, rw, out_hw, bulk, 4, 16)
        bh, bw = ra._grid_pair(bulk)
        n_large = int(((torch.ceil(rh / out_hw[0]) > bh) | (torch.ceil(rw / out_hw[1]) > bw)).sum())
        n_full = int((grid != ra.adaptive_grid(rh, rw, out_hw, bulk)).any(1).sum())
    return pyr, levels, grid, out_hw, n_large, n_full


def phase_k1(rng, rois_np):
    from glass_tpu_torch.ops import roi_align_rotated as ra

    rois = torch.from_numpy(rois_np).cuda()
    rows = []
    for name, *_ in POOLERS:
        for dtype in (torch.float32, torch.bfloat16):
            pyr, levels, grid, out_hw, n_large, n_full = pooler_inputs(name, rng, dtype, rois)
            got = ra.roi_align_rotated_packed(pyr.flat, pyr.meta, rois, levels, grid, out_hw)
            ref = ra.roi_align_rotated_packed_plain(pyr.flat, pyr.meta, rois, levels, grid, out_hw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            # f32: same arithmetic in the same order (no FMA contraction);
            # bf16: both round one f32 accumulator, so at most one bf16 ulp.
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * max(1.0, ref.float().abs().max().item())
            launch = lambda: ra.roi_align_rotated_packed(pyr.flat, pyr.meta, rois, levels, grid, out_hw)  # noqa: E731
            ms = kernel_ms(launch)
            call = time_ms(launch, 50)
            plain = time_ms(lambda: ra.roi_align_rotated_packed_plain(pyr.flat, pyr.meta, rois, levels, grid, out_hw), 3, 1)
            elt = pyr.flat.element_size()
            c = pyr.flat.shape[1]
            samples = int((grid[:, 0] * grid[:, 1]).sum()) * out_hw[0] * out_hw[1]
            nbytes = (touched_rows(pyr.meta, rois, levels, grid, out_hw) * c * elt
                      + rois.shape[0] * out_hw[0] * out_hw[1] * c * elt + rois.shape[0] * 7 * 4)
            b_ms, b_by = bound(nbytes, samples * c * 8)
            rows.append(dict(pooler=name, dtype=str(dtype).split(".")[1], err=err, tol=tol, ms=ms,
                             call_ms=call, plain_ms=plain, bound_ms=b_ms, bound_by=b_by))
            log(f"K1 {name:10s} {out_hw} {rows[-1]['dtype']:8s} large rois {n_large:3d} "
                f"(budget 16, {n_full:2d} on the full grid) "
                f"max|err| {err:.3g} (tol {tol:.3g}) kernel {ms:.4f} ms (wrapper call {call:.4f} ms) "
                f"plain {plain:.3f} ms bound {b_ms:.4f} ms ({b_by})")
            if not err <= tol:
                raise AssertionError(f"K1 {name} {dtype}: max|err| {err} > {tol}")
    return rows


def phase_k2(rng, rois_np):
    from glass_tpu_torch.ops import crop as cr
    from glass_tpu_torch.ops.roi_align_rotated import adaptive_grid, fixed_grid

    h, w = BUCKET_HW
    rois = torch.from_numpy(rois_np).cuda()
    raw = torch.from_numpy(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).cuda()
    mean = torch.tensor([103.53, 116.28, 123.675], device="cuda")
    std = torch.tensor([57.375, 57.12, 58.395], device="cuda")
    norm32 = (raw.float() - mean) / std
    rows = []
    for label, image, normalize in (("uint8+fold", raw, (mean, std)),
                                    ("float32", norm32, None),
                                    ("bfloat16", norm32.to(torch.bfloat16), None)):
        for sr in (1, 2, 0):
            got = cr.crop_rois(image, rois, (128, 128), sr, 2, normalize)
            ref = cr.crop_rois_plain(image, rois, (128, 128), sr, 2, normalize)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            if image.dtype == torch.bfloat16:
                tol = 2.0 ** -7 * max(1.0, ref.float().abs().max().item())
            else:
                tol = 1e-4 * 255.0 / float(std.min()) if normalize else 1e-4
            launch = lambda: cr.crop_rois(image, rois, (128, 128), sr, 2, normalize)  # noqa: E731
            ms = kernel_ms(launch)
            call = time_ms(launch, 50)
            plain = time_ms(lambda: cr.crop_rois_plain(image, rois, (128, 128), sr, 2, normalize), 3, 1)
            grid = fixed_grid(rois.shape[0], sr, "cuda") if sr > 0 else adaptive_grid(rois[:, 3], rois[:, 2], (128, 128), 2)
            meta = torch.tensor([[1.0, h, w, 0.0]], device="cuda")
            levels = torch.zeros((rois.shape[0],), dtype=torch.int32, device="cuda")
            samples = int((grid[:, 0] * grid[:, 1]).sum()) * 128 * 128
            nbytes = (touched_rows(meta, rois, levels, grid, (128, 128)) * 3 * image.element_size()
                      + got.numel() * got.element_size() + rois.numel() * 4)
            b_ms, b_by = bound(nbytes, samples * 3 * 8)
            rows.append(dict(input=label, sr=sr, err=err, tol=tol, ms=ms, call_ms=call,
                             plain_ms=plain, bound_ms=b_ms, bound_by=b_by))
            log(f"K2 {label:10s} sr={sr} max|err| {err:.3g} (tol {tol:.3g}) kernel {ms:.4f} ms "
                f"(wrapper call {call:.4f} ms) plain {plain:.3f} ms bound {b_ms:.4f} ms ({b_by})")
            if not err <= tol:
                raise AssertionError(f"K2 {label} sr={sr}: max|err| {err} > {tol}")
    return rows


def icdar15_cfg(dtype: str):
    """configs/glass_finetune_icdar15.yaml + the protocol overrides of
    tools/eval_glass.py, then opts."""
    from glass_tpu_torch.config import get_cfg

    cfg = get_cfg(ICDAR15)
    cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.35
    cfg.INFERENCE_TH_TEST = 0.3
    cfg.INFERENCE_DETECTION_TH_TEST = 0.65
    cfg.POST_PROCESSING.TEXT_THRESHOLD = 0.3
    cfg.POST_PROCESSING.DETECT_THRESHOLD = 0.65
    cfg.INPUT.MIN_SIZE_TEST = 1000
    cfg.INPUT.MAX_SIZE_TEST = 1600
    cfg.MODEL.ROI_MASK_HEAD.MASK_INFERENCE = True
    cfg.MODEL.ROI_ORIENTATION_HEAD.APPLY_TO_BOXES = False
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", dtype])
    return cfg


def seeded_weights(image: np.ndarray) -> dict:
    """Seeded random weights with BN statistics calibrated on one image
    (f32, on the card)."""
    from glass_tpu_torch.inference.runner import calibrate_batch_norm_, random_init_
    from glass_tpu_torch.models import GlassArch, GlassRCNN

    arch = GlassArch.from_config(icdar15_cfg("float32"))
    model = random_init_(GlassRCNN(arch), seed=0).eval().cuda()
    h, w = image.shape[:2]
    padded = np.zeros(BUCKET_HW + (3,), np.float32)
    padded[:h, :w] = image
    calibrate_batch_norm_(model, torch.from_numpy(padded).cuda(), (h, w))
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _stage_kernels(event):
    """(op, kernel name, µs) of every kernel launched under ``event``; op is
    the innermost profiled call that launched it (an aten op, or the stage
    span itself for the ctypes-launched K1/K2)."""
    out = [(event.name, k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        out += _stage_kernels(child)
    return out


def profile_model(runner, image, out_dir):
    """torch.profiler over one model call: device busy share, the kernels
    that take the most device time, and each stage span's kernels (count,
    device time, and the ops that launched them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_model(image)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side copies of the stage spans (gpu_user_annotation) and the
    # profiler's own buffer requests are not device work
    not_work = set(STAGES) | {"Activity Buffer Request"}
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)
              and e.key not in not_work]
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e3
    try:
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    except (AttributeError, KeyError):  # older profilers name the key after CUDA
        table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    n_device = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.name not in not_work)
    lines = []
    staged_ms = staged_n = 0
    for span in (e for e in prof.events() if e.device_type == DeviceType.CPU and e.name in STAGES):
        ks = _stage_kernels(span)
        ms = sum(k[2] for k in ks) / 1e3
        staged_ms += ms
        staged_n += len(ks)
        elem = [k for k in ks if "elementwise" in k[1]]
        by_op = collections.Counter()
        op_ms = collections.Counter()
        for op, _, us in ks:
            by_op[op] += 1
            op_ms[op] += us / 1e3
        top = ", ".join(f"{op} x{n} {op_ms[op]:.2f} ms" for op, n in by_op.most_common(5))
        lines.append(f"  {span.name:17s} {len(ks):5d} kernels {ms:8.3f} ms device; "
                     f"elementwise x{len(elem)} {sum(k[2] for k in elem) / 1e3:.3f} ms; by op: {top}")
    lines.append(f"  stages hold {staged_n} of {n_device} device records (kernels, copies) and "
                 f"{staged_ms:.3f} of {dev_ms:.3f} ms device time")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_main_path.txt"), "w") as f:
        f.write(table + "\n\nper stage span:\n" + "\n".join(lines) + "\n")
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    log(f"profile (one model call, {wall_ms:.1f} ms wall): device busy {dev_ms:.1f} ms "
        f"= {100 * dev_ms / wall_ms:.1f}% of wall, {n_device} device records (kernels, copies)")
    for e in top:
        log(f"  {getattr(e, 'self_device_time_total', 0.0) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    log("profile per stage span:")
    for line in lines:
        log(line)
    return wall_ms, dev_ms


def phase_main(images, state_dict, n_timed, out_dir):
    """GlassRunner.__call__ at bf16 on the card: 2 warm-up images, then
    ``n_timed`` timed ones cycling through ``images``.  Spans around
    ``__call__`` and around its ``run_model`` (upload, device work, fetch)
    split each image's time into model and host (resize, post-processing)."""
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.ops import _cuda

    runner = GlassRunner(cfg=icdar15_cfg("bfloat16"), state_dict=state_dict, device="cuda")
    model_ms = []
    run_model = runner.run_model

    def timed_run_model(image):
        t0 = time.perf_counter()
        out = run_model(image)  # ends in the fetch to numpy, so the device is done
        model_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    runner.run_model = timed_run_model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.LAUNCHES.clear()
    times, results = [], []
    for i in range(2 + n_timed):
        img = images[i % len(images)]
        t0 = time.perf_counter()
        preds = runner(img)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        results.append(preds)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    runner.run_model = run_model
    n_img = len(times)
    log(f"main path launches over {n_img} images: {launches}")
    for k in ("roi_align_rotated", "crop_rois"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    total, model = np.asarray(times[2:]), np.asarray(model_ms[2:])
    host = total - model
    q = lambda a, p: float(np.percentile(a, p))  # noqa: E731
    log(f"main path ({card_line()}): {len(total)} timed images through __call__ (2 warm-up); "
        f"ms/image median {q(total, 50):.2f}, p75 {q(total, 75):.2f}, p90 {q(total, 90):.2f}, "
        f"max {total.max():.2f}; {1e3 / q(total, 50):.2f} img/s at the median; peak memory {peak:.0f} MiB")
    log(f"main path split: model (run_model) median {q(model, 50):.2f} ms, p75 {q(model, 75):.2f}, "
        f"p90 {q(model, 90):.2f}; host (resize, post-processing) median {q(host, 50):.2f} ms, "
        f"p90 {q(host, 90):.2f}")
    log(f"main path per image ms: {[round(t, 1) for t in times]}")
    valid = [len(r) for r in results]
    log(f"main path words after post-processing per image: {valid}")
    raw = runner.run_on_resized(images[0].astype(np.float32))
    raw_texts = runner.decode_texts(raw)[0] if len(raw) else []
    log(f"main path: {len(raw)} raw valid detections on image 0; first decoded texts {raw_texts[:6]}")
    profile_model(runner, images[0].astype(np.float32), out_dir)
    return dict(median_ms=q(total, 50), p75_ms=q(total, 75), p90_ms=q(total, 90), peak_mib=peak,
                launches=launches, n_images=n_img)


def _box_dist(a, b):
    """Per-row distance of rotated boxes: max over |dx|, |dy|, |dw|, |dh|
    (pixels) and the wrapped angle difference (degrees)."""
    d = np.abs(a[..., :4] - b[..., :4])
    ang = np.abs((a[..., 4] - b[..., 4] + 180.0) % 360.0 - 180.0)
    return np.maximum(d.max(-1), ang)


def _pair_rows(boxes_a, boxes_b):
    """One-to-one pairing of two detection sets by nearest box (greedy in
    a's row order): index into b for every row of a."""
    used, pair = np.zeros(len(boxes_b), bool), []
    for box in boxes_a:
        d = _box_dist(box[None], boxes_b)
        d[used] = np.inf
        j = int(np.argmin(d))
        used[j] = True
        pair.append(j)
    return np.asarray(pair, int)


# Phase 5 tolerances (PERF.md states them with their reasons).  Staged:
# each stage on both devices from the same inputs.
FEATURE_REL_TOL = 1e-3     # max|card - CPU| / max|CPU| per FPN level
BOX_ATOL, BOX_RTOL = 0.05, 1e-4
SCORE_ATOL = 1e-3
PROB_ATOL = 1e-3           # text step probabilities and mask probabilities
KNIFE_EDGE = 1e-4          # top-two margin under which a decoding step may flip
# End to end, each device from the image alone: the stages' differences
# compound (a box a fraction of a pixel off pools other samples).
E2E_BOX_ATOL, E2E_BOX_RTOL = 0.5, 1e-3
E2E_MASK_ATOL = 5e-2


def phase_whole(image, state_dict):
    """The f32 port (no TF32) on the card against the f32 port on the CPU
    (plain kernel versions), same weights, one full-size image.

    Staged: every CPU stage takes the card's inputs to that stage, so each
    stage's comparison sees only its own arithmetic (cuDNN vs CPU
    convolutions, kernels vs plain versions).  Then the whole path run
    independently on both: equal valid counts, and rows paired one to one
    by box that agree within the end-to-end tolerances."""
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.models import glass_rcnn as gr

    cfg = icdar15_cfg("float32")
    gpu_r = GlassRunner(cfg=cfg, state_dict=state_dict, device="cuda")
    cpu_r = GlassRunner(cfg=cfg, state_dict=state_dict, device="cpu")
    h, w = image.shape[:2]
    hw = (h, w)
    padded = np.zeros(BUCKET_HW + (3,), np.float32)
    padded[:h, :w] = image
    failed = []

    def check(name, ok, text):
        log(f"whole path {name}: {text} -> {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(name)

    gm, cm = gpu_r.model, cpu_r.model
    with torch.inference_mode():
        norm = gr.preprocess(gm, torch.from_numpy(padded).cuda())
        feats = gr.backbone_features(gm, norm)
        cpu_feats = gr.backbone_features(cm, norm.cpu())
        for k in cpu_feats:
            rel = float((feats[k].cpu() - cpu_feats[k]).abs().max() / cpu_feats[k].abs().max())
            check(f"backbone {k}", rel <= FEATURE_REL_TOL, f"max|card-CPU| / max|CPU| {rel:.3g} (tol {FEATURE_REL_TOL})")
        fc = {k: v.cpu() for k, v in feats.items()}
        pyr, cpu_pyr = gr.pack_box_pyramid(gm, feats), gr.pack_box_pyramid(cm, fc)

        pb, _, pv = gr.rpn_proposals_single(gm, feats, hw)
        cb, _, cv = gr.rpn_proposals_single(cm, fc, hw)
        pb, pv, cb, cv = pb.cpu().numpy(), pv.cpu().numpy(), cb.numpy(), cv.numpy()
        n_far = -1
        if pv.sum() == cv.sum():
            d = _box_dist(pb[pv], cb[cv])
            n_far = int((d > BOX_ATOL + BOX_RTOL * np.abs(cb[cv][:, :4]).max(-1)).sum())
        log(f"whole path proposals from the card's features: valid card {int(pv.sum())} CPU {int(cv.sum())}, "
            f"rows whose box differs {n_far} (diagnostic; a top-k or NMS near-tie reorders them)")

        det = gr.detect_single_image(gm, feats, pyr, hw)
        cdet = gr.detect_single_image(cm, fc, cpu_pyr, hw)
        dv, cdv = det.valid.cpu().numpy(), cdet.valid.numpy()
        check("detections valid", int(dv.sum()) == int(cdv.sum()), f"card {int(dv.sum())} CPU {int(cdv.sum())}")
        db, ds = det.boxes.cpu().numpy()[dv], det.scores.cpu().numpy()[dv]
        cb, cs_ = cdet.boxes.numpy()[cdv], cdet.scores.numpy()[cdv]
        if len(db) == len(cb) and len(db):
            pair = _pair_rows(db, cb)
            d = _box_dist(db, cb[pair])
            box_ok = d <= BOX_ATOL + BOX_RTOL * np.abs(cb[pair][:, :4]).max(-1)
            score_err = np.abs(ds - cs_[pair])
            log(f"whole path detections: {int((pair != np.arange(len(pair))).sum())} of {len(pair)} rows "
                f"sit at another row on the CPU; max box diff {d.max():.3g}, max score diff {score_err.max():.3g}")
            check("detection boxes", bool(box_ok.all()),
                  f"{int((~box_ok).sum())} rows outside {BOX_ATOL} px + {BOX_RTOL} rel")
            check("detection scores", bool((score_err <= SCORE_ATOL).all()),
                  f"{int((score_err > SCORE_ATOL).sum())} rows outside {SCORE_ATOL}")

        # recognizer and mask head on the card's detection set (all rows)
        probs = gr.recognize_single_image(gm, feats, norm, det.boxes).cpu().numpy()
        cprobs = gr.recognize_single_image(cm, fc, norm.cpu(), det.boxes.cpu()).numpy()
        top2 = np.sort(cprobs, -1)[..., -2:]
        steps = ~np.cumsum(top2[..., 1] - top2[..., 0] < KNIFE_EDGE, axis=1).astype(bool)
        perr = float(np.abs(probs - cprobs)[steps].max())
        check("text probabilities", perr <= PROB_ATOL,
              f"max|card-CPU| {perr:.3g} over {int(steps.sum())} of {steps.size} steps before a knife edge (tol {PROB_ATOL})")
        same_ids = bool((probs.argmax(-1)[steps] == cprobs.argmax(-1)[steps]).all())
        check("text ids", same_ids, f"equal on every step before a knife edge: {same_ids}")
        masks = gr.mask_single_image(gm, pyr, det.boxes, det.classes).cpu().numpy()
        cmasks = gr.mask_single_image(cm, cpu_pyr, det.boxes.cpu(), det.classes.cpu()).numpy()
        merr = float(np.abs(masks - cmasks).max())
        check("mask probabilities", merr <= PROB_ATOL, f"max|card-CPU| {merr:.3g} (tol {PROB_ATOL})")

    # the whole path, each side on its own
    gpu = gpu_r.run_model(image.astype(np.float32))
    t0 = time.perf_counter()
    cpu = cpu_r.run_model(image.astype(np.float32))
    log(f"whole path: CPU run {time.perf_counter() - t0:.1f} s")
    gv, cv = np.nonzero(gpu["valid"])[0], np.nonzero(cpu["valid"])[0]
    check("end-to-end valid", len(gv) == len(cv), f"card {len(gv)} CPU {len(cv)}")
    if len(gv) == len(cv) and len(gv):
        pair = cv[_pair_rows(gpu["boxes"][gv], cpu["boxes"][cv])]
        a, b = gpu["boxes"][gv], cpu["boxes"][pair]
        box_d = _box_dist(a, b)
        box_ok = box_d <= E2E_BOX_ATOL + E2E_BOX_RTOL * np.abs(b[:, :4]).max(-1)
        score_d = np.abs(gpu["scores"][gv] - cpu["scores"][pair])
        mask_d = np.abs(gpu["mask_probs"][gv].astype(np.float32)
                        - cpu["mask_probs"][pair].astype(np.float32)).reshape(len(gv), -1).max(-1)
        same_text = np.all(gpu["text_ids"][gv] == cpu["text_ids"][pair], axis=1)
        log(f"whole path end to end: {int((pair != gv).sum())} of {len(gv)} rows sit at another row "
            f"on the CPU; identical text ids on {same_text.mean():.3f} of rows")
        check("end-to-end boxes", bool(box_ok.all()),
              f"max diff {box_d.max():.3g}, median {np.median(box_d):.3g}; {int((~box_ok).sum())} rows "
              f"outside {E2E_BOX_ATOL} px + {E2E_BOX_RTOL} rel")
        check("end-to-end scores", bool((score_d <= SCORE_ATOL).all()),
              f"max diff {score_d.max():.3g}, median {np.median(score_d):.3g} (tol {SCORE_ATOL})")
        check("end-to-end masks", bool((mask_d <= E2E_MASK_ATOL).all()),
              f"max diff {mask_d.max():.3g}, median {np.median(mask_d):.3g} (tol {E2E_MASK_ATOL})")
    if failed:
        raise AssertionError(f"whole path differs beyond tolerance in {failed}")


def kernel_entry(name, source, replaces, launches, rows):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
        "library_ms": None,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", default="1,2,3,4,5")
    ap.add_argument("--out", default="chip_smoke_out", help="directory for the build log and the profile table")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
        sys.exit(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import glass_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = card_line()
    log(card)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    rng = np.random.RandomState(0)
    rois_np = word_rois(rng, N_ROIS, *BUCKET_HW)
    k1_rows = k2_rows = None
    main = None
    if 1 in phases:
        phase_build(args.out)
    if 2 in phases:
        k1_rows = phase_k1(rng, rois_np)
    if 3 in phases:
        k2_rows = phase_k2(rng, rois_np)
    if 4 in phases or 5 in phases:
        images = [synthetic_image(np.random.RandomState(100 + i), 720, 1280) for i in range(N_IMAGES)]
        state_dict = seeded_weights(images[0])
        if 4 in phases:
            main = phase_main(images, state_dict, N_TIMED, args.out)
        if 5 in phases:
            phase_whole(images[0], state_dict)

    kernels = []
    launches = (main or {}).get("launches", {})
    per_image = (main or {}).get("n_images", 1)
    if k1_rows:
        rows = [r for r in k1_rows if r["dtype"] == "bfloat16"]
        entry = kernel_entry("roi_align_rotated", "glass_tpu_torch/csrc/roi_align_rotated.cu",
                             "glass_tpu/ops/pallas_roi_align.py:33",
                             launches.get("roi_align_rotated", 0), rows)
        entry["max_abs_err"] = max(r["err"] for r in k1_rows)
        kernels.append(entry)
    if k2_rows:
        rows = [r for r in k2_rows if r["input"] == "bfloat16" and r["sr"] == 1]
        entry = kernel_entry("crop_rois", "glass_tpu_torch/csrc/crop_rois.cu",
                             "glass_tpu/ops/pallas_crop.py:77", launches.get("crop_rois", 0), rows)
        entry["max_abs_err"] = max(r["err"] for r in k2_rows)
        kernels.append(entry)
    log(f"kernel times are per image at the main-path shapes (bfloat16; K1 summed over its "
        f"three poolers), launches over {per_image} main-path images, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
