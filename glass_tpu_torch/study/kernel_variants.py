"""Device time of design alternatives of kernels K1, K1b and K2 beside
the shipped kernels, at the main-path shapes of ``chip_smoke.py`` phases 2-3
(K1, K2) and the training shapes of phase 7 (K1b).

    python3 -m glass_tpu_torch.study.kernel_variants [--out DIR] [--kernels k1,k1b,k2]

run from the root of the repo on one GPU.  It builds ``kernel_variants.cu``
(which includes the kernels' sources) with the port's nvcc flags into the
port's build directory, and compares with the shipped kernel, each case on
the same inputs:

  K1, at the box, mask and recognizer poolers (f32 and bf16) and the mask
      pooler with every roi on the full 4x4 grid: other tiles of bins than
      the shipped band of all bin rows by max(2, 16 // rows) columns;
  K2, for uint8 with the fold, f32 and bf16 at sampling ratios 1, 2 and 0:
      1, 2, 4 and 8 output rows a block (shipped: 3); the roi frame computed
      once a block into shared memory behind a barrier (shipped: in every
      thread); a run of 16 bytes' worth of pixels a thread written as
      16-byte stores (shipped: one pixel a thread, three scalar stores);
  K1b, at the box, mask and recognizer poolers of phase 7 (bf16 and f32,
      the output in the features' dtype): the whole backward of the shipped
      kernels (mark, scatter, finish) against the per-tap form (the baseline:
      its f32 buffer zeroed whole, one scalar L2 atomic a tap and channel,
      then cast), the shipped design without marks (the accumulator zeroed
      whole, every row read back), every tile on the direct path, a scalar
      flush, 1 and 4 channels a scatter thread (shipped: 2), the first form
      of the redesign (shared atomics into a tile of all footprint rows,
      32-channel chunks), other tiles of bins and 16, 40 and 64 accumulator
      rows.  Each label gives the tiles the plan
      sends to the direct path (``backward_direct_tiles``); the shipped
      call's device time is also split by kernel (``torch.profiler``).

K1 and K2 alternatives must equal the shipped kernel's output bit for bit.
K1b's outputs are not bit-equal from run to run, since its shared and
global atomics add in another order each run: each must agree with the
plain version within phase 7's bound (``chip_smoke.k1b_excess``: two
reordered f32 sums, plus one bf16 ulp for a bf16 output).
Times are ``chip_smoke.kernel_ms`` (the mean of a CUDA graph of 50 calls),
taken in two passes that interleave the shipped kernel and its
alternatives.  Prints one line per case and writes every time, with the
card's name and power limit, to ``DIR/kernel_variants.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
PASSES = 2
FRAME_ONCE, VECTOR_STORE = 1, 2  # kernel_variants.cu CropVariant
# kernel_variants.cu K1bVariant
K1B_SHIPPED, K1B_SCALAR_FLUSH, K1B_SHARED_ATOMICS, K1B_MEMSET_CAST, K1B_VEC1, K1B_VEC4 = range(6)
K1B_TILES = {"box": [(7, 1), (4, 2), (2, 2), (1, 2)], "mask": [(14, 1), (7, 1), (4, 4), (2, 2)],
             "recognizer": [(8, 2), (4, 2), (8, 1), (1, 2)]}
K1B_SLOTS = (16, 40, 64)
# the first form of the redesign: its tiles, shared footprint rows (of 32
# channels) and blocks over a tile's 32-channel chunks
K1B_SHARED_PLAN = {"box": ((7, 2), 640, 1), "mask": ((7, 2), 640, 1), "recognizer": ((8, 2), 640, 4)}
K1_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
K2_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def build(out_dir: str) -> ctypes.CDLL:
    """The study library, built unless a build of the same sources and
    flags exists; the compiler log goes to ``out_dir``."""
    from glass_tpu_torch.ops import _cuda

    src = os.path.join(HERE, "kernel_variants.cu")
    deps = [src] + [os.path.join(_cuda.CSRC, n) for n in
                    [f"{k}.cu" for k in _cuda.KERNEL_SOURCES] + list(_cuda.HEADERS)]
    h = hashlib.sha256(" ".join(_cuda.NVCC_FLAGS).encode())
    for path in deps:
        with open(path, "rb") as f:
            h.update(f.read())
    lib_path = os.path.join(_cuda.build_dir(), f"libkernel_variants-{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        os.makedirs(_cuda.build_dir(), exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        res = subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", tmp, src],
                             capture_output=True, text=True)
        with open(os.path.join(out_dir, "kernel_variants_build.log"), "w") as f:
            f.write(res.stdout + res.stderr)
        if res.returncode:
            raise RuntimeError(f"nvcc exit {res.returncode}\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.study_roi_align_tile.argtypes = [p, i, i, p, p, p, p, i, i, i, i, i, p, p]
    lib.study_crop_rows.argtypes = [p, i, i, i, p, i, i, i, i, i, i, p, p, i, p, p]
    lib.study_crop_variant.argtypes = [i, p, i, i, i, p, i, i, i, i, i, i, p, p, p, p]
    lib.study_k1b_variant.argtypes = [i, p, i, i, i, p, p, p, p, i, i, i, i, i, i, i, i,
                                      ctypes.c_longlong, p, p, p, p, p, p]
    lib.study_k1b_baseline.argtypes = [p, i, i, p, p, p, p, i, i, i, p, p]
    lib.study_k1b_occupancy.argtypes = [i, i]
    lib.glass_roi_align_rotated_backward_unit_bytes.restype = i
    lib.study_k1b_trace.argtypes = [p, i, i, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_longlong,
                                    p, p, p, p, p, p, p]
    for fn in (lib.study_roi_align_tile, lib.study_crop_rows, lib.study_crop_variant,
               lib.study_k1b_variant, lib.study_k1b_baseline, lib.study_k1b_occupancy,
               lib.study_k1b_trace):
        fn.restype = i
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _checked(status: int) -> None:
    if status != 0:
        raise RuntimeError(f"study kernel launch failed with cudaError {status}")


def compare(label: str, launches: dict, kernel_ms, excess=None) -> dict:
    """Device times of each launch in ``launches`` (the first is the shipped
    kernel), after checking each output: equal to the first's bit for bit,
    or with ``excess`` (output -> float) at most 0."""
    ref = next(iter(launches.values()))()
    for name, fn in launches.items():
        got = fn()
        torch.cuda.synchronize()
        if excess is not None:
            over = excess(got)
            if not over <= 0.0:
                raise AssertionError(f"{label} {name}: output exceeds the bound by {over}")
        elif not torch.equal(got, ref):
            raise AssertionError(f"{label} {name}: output differs from the shipped kernel's")
    times = {name: [] for name in launches}
    for _ in range(PASSES):
        for name, fn in launches.items():
            times[name].append(kernel_ms(fn))
    shipped = min(next(iter(times.values())))
    print(f"{label}: " + " | ".join(
        f"{name} {', '.join(f'{t:.4f}' for t in ts)} ms ({min(ts) / shipped:.2f}x)"
        for name, ts in times.items()), flush=True)
    return times


def study_k1(lib, smoke) -> dict:
    from glass_tpu_torch.ops import roi_align_rotated as ra

    rng = np.random.RandomState(0)
    rois = torch.from_numpy(smoke.word_rois(rng, smoke.N_ROIS, *smoke.BUCKET_HW)).cuda()
    cases = [(name, dtype, None) for name, *_ in smoke.POOLERS
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [("mask", dtype, 4) for dtype in (torch.float32, torch.bfloat16)]
    results = {}
    for name, dtype, full in cases:
        pyr, levels, grid, out_hw, _, _ = smoke.pooler_inputs(name, rng, dtype, rois)
        if full:
            grid = ra.fixed_grid(rois.shape[0], full, "cuda")
        levels, grid = levels.to(torch.int32).contiguous(), grid.to(torch.int32).contiguous()
        ph, pw = out_hw
        c = pyr.flat.shape[1]

        def tile_launch(tile):
            def run():
                out = torch.empty((rois.shape[0], ph, pw, c), dtype=dtype, device="cuda")
                _checked(lib.study_roi_align_tile(
                    pyr.flat.data_ptr(), K1_DTYPES[dtype], c, rois.data_ptr(), pyr.meta.data_ptr(),
                    levels.data_ptr(), grid.data_ptr(), rois.shape[0], ph, pw, tile[0], tile[1],
                    out.data_ptr(), _stream()))
                return out
            return run

        launches = {"shipped": lambda: ra.roi_align_rotated_packed(pyr.flat, pyr.meta, rois, levels,
                                                                   grid, out_hw)}
        for tile in ((1, 16), (2, 8), (4, 8), (ph, 1), (ph, 4), (ph, 8)):
            tile = (min(tile[0], ph), min(tile[1], pw))
            launches[f"tile {tile[0]}x{tile[1]}"] = tile_launch(tile)
        label = f"K1 {name}{' full 4x4 grid' if full else ''} {out_hw} {str(dtype)[6:]}"
        results[label] = compare(label, launches, smoke.kernel_ms)
    return results


def study_k2(lib, smoke) -> dict:
    from glass_tpu_torch.ops import crop as cr

    h, w = smoke.BUCKET_HW
    rng = np.random.RandomState(0)
    rois = torch.from_numpy(smoke.word_rois(rng, smoke.N_ROIS, h, w)).cuda()
    raw = torch.from_numpy(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).cuda()
    mean = torch.tensor([103.53, 116.28, 123.675], device="cuda")
    std = torch.tensor([57.375, 57.12, 58.395], device="cuda")
    norm32 = (raw.float() - mean) / std
    images = (("uint8+fold", raw, (mean, std)), ("float32", norm32, None),
              ("bfloat16", norm32.to(torch.bfloat16), None))
    oh = ow = 128
    results = {}
    for label, image, normalize in images:
        fold = int(normalize is not None)
        mp, sp = (mean.data_ptr(), std.data_ptr()) if fold else (None, None)
        out_dtype = torch.float32 if image.dtype == torch.uint8 else image.dtype
        for sr in (1, 2, 0):
            def rows_launch(rows, sr=sr, image=image):
                def run():
                    out = torch.empty((rois.shape[0], oh, ow, 3), dtype=out_dtype, device="cuda")
                    _checked(lib.study_crop_rows(
                        image.data_ptr(), K2_DTYPES[image.dtype], h, w, rois.data_ptr(), rois.shape[0],
                        sr, 2, oh, ow, fold, mp, sp, rows, out.data_ptr(), _stream()))
                    return out
                return run

            def variant_launch(variant, sr=sr, image=image):
                def run():
                    out = torch.empty((rois.shape[0], oh, ow, 3), dtype=out_dtype, device="cuda")
                    _checked(lib.study_crop_variant(
                        variant, image.data_ptr(), K2_DTYPES[image.dtype], h, w, rois.data_ptr(),
                        rois.shape[0], sr, 2, oh, ow, fold, mp, sp, out.data_ptr(), _stream()))
                    return out
                return run

            launches = {"shipped": lambda sr=sr, image=image, normalize=normalize:
                        cr.crop_rois(image, rois, (oh, ow), sr, 2, normalize)}
            for rows in (1, 2, 4, 8):
                launches[f"{rows} rows"] = rows_launch(rows)
            launches["frame once"] = variant_launch(FRAME_ONCE)
            launches["vector stores"] = variant_launch(VECTOR_STORE)
            case = f"K2 {label} sr={sr}"
            results[case] = compare(case, launches, smoke.kernel_ms)
    return results


def kernel_split(fn, calls: int = 10) -> dict:
    """Mean device ms a call of each kernel that ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            split[e.key] = us / calls / 1e3
    return split


def study_k1b(lib, smoke) -> dict:
    from glass_tpu_torch.ops import roi_align_rotated as ra

    h, w = smoke.TRAIN_BUCKET_HW
    rng = np.random.RandomState(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name, n in smoke.TRAIN_ROIS.items():
        rois = torch.from_numpy(smoke.word_rois(rng, n, h, w)).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            pyr, levels, grid, out_hw = smoke._train_pooler_inputs(name, rng, dtype, rois)
            meta = pyr.meta.contiguous()
            levels, grid = levels.to(torch.int32).contiguous(), grid.to(torch.int32).contiguous()
            ph, pw = out_hw
            c, n_rows = pyr.flat.shape[1], pyr.flat.shape[0]
            g = torch.from_numpy(rng.randn(n, ph, pw, c).astype(np.float32)).cuda().to(dtype)
            ref, tol, _ = smoke.k1b_reference(meta, rois, levels, grid, out_hw, n_rows, g)
            tile = ra.backward_tile(n, out_hw, sms)

            def direct(tile, rows=ra.FOOTPRINT_ROWS, slots=ra.SLOT_ROWS, meta=meta, levels=levels,
                       grid=grid, out_hw=out_hw):
                return ra.backward_direct_tiles(meta, rois, levels, grid, out_hw, tile, rows, slots)

            def variant(v, tile=tile, rows=ra.FOOTPRINT_ROWS, slots=ra.SLOT_ROWS, groups=1, g=g,
                        dtype=dtype, n_rows=n_rows, c=c, meta=meta, levels=levels, grid=grid):
                def run():
                    out = torch.empty((n_rows, c), dtype=dtype, device="cuda")
                    acc = out if dtype == torch.float32 else torch.empty((n_rows, c), dtype=torch.float32,
                                                                         device="cuda")
                    stats = torch.empty(2, dtype=torch.int32, device="cuda")
                    flags = ra._unit_flags(out.device, -(-n_rows // ra.UNIT_ROWS))
                    info = ra.backward_unit_info(lib, n * -(-ph // tile[0]) * -(-pw // tile[1]), "cuda")
                    _checked(lib.study_k1b_variant(
                        v, g.data_ptr(), K1_DTYPES[dtype], K1_DTYPES[dtype], c, rois.data_ptr(),
                        meta.data_ptr(), levels.data_ptr(), grid.data_ptr(), n, ph, pw, tile[0], tile[1],
                        rows, slots, groups, n_rows, acc.data_ptr(), out.data_ptr(), flags.data_ptr(),
                        stats.data_ptr(), info.data_ptr(), _stream()))
                    return out
                return run

            def baseline(g=g, dtype=dtype, n_rows=n_rows, c=c, meta=meta, levels=levels, grid=grid):
                acc = torch.zeros((n_rows, c), dtype=torch.float32, device="cuda")
                _checked(lib.study_k1b_baseline(
                    g.data_ptr(), K1_DTYPES[dtype], c, rois.data_ptr(), meta.data_ptr(), levels.data_ptr(),
                    grid.data_ptr(), n, ph, pw, acc.data_ptr(), _stream()))
                return acc.to(dtype)

            def shipped(g=g, dtype=dtype, meta=meta, levels=levels, grid=grid, n_rows=n_rows):
                return ra.roi_align_rotated_packed_backward(g, meta, rois, levels, grid, n_rows,
                                                            out_dtype=dtype)

            shared_tile, shared_rows, shared_groups = K1B_SHARED_PLAN[name]
            launches = {
                f"shipped {tile[0]}x{tile[1]} ({direct(tile)} direct)": shipped,
                "per-tap form + cast": baseline,
                "memset + cast": variant(K1B_MEMSET_CAST),
                "direct only": variant(K1B_SHIPPED, rows=1),
                "scalar flush": variant(K1B_SCALAR_FLUSH),
                "1 channel a thread": variant(K1B_VEC1),
                "4 channels a thread": variant(K1B_VEC4),
                "shared atomics (first form)": variant(K1B_SHARED_ATOMICS, tile=shared_tile,
                                                       rows=shared_rows, groups=shared_groups),
            }
            for t in K1B_TILES[name]:
                launches[f"tile {t[0]}x{t[1]} ({direct(t)} direct)"] = variant(K1B_SHIPPED, tile=t)
            for slots in K1B_SLOTS:
                launches[f"{slots} slots ({direct(tile, slots=slots)} direct)"] = variant(K1B_SHIPPED,
                                                                                        slots=slots)
            label = f"K1b {name} {out_hw} {str(dtype)[6:]}"
            results[label] = compare(label, launches, smoke.kernel_ms,
                                     excess=lambda got, ref=ref, tol=tol: smoke.k1b_excess(got, ref, tol))
            split = kernel_split(shipped)
            print(f"{label} shipped, device ms a call by kernel: " + ", ".join(
                f"{k.split('k1b')[-1][2:22]} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1])),
                flush=True)
            results[label + " split"] = split
    return results


K1B_TRACE_STAMPS = 6  # roi_align_rotated_backward.cu kTraceStamps
K1B_PHASES = ("frame", "table", "scan", "accumulate", "flush")


def k1b_trace(lib, g, meta, rois, levels, grid, n_rows, tile) -> dict:
    """One shipped K1b call with the scatter's phase trace: the scatter's
    span, each block's time and each phase's mean time (ns, from
    %globaltimer), and how many blocks ran at once (the mean, and the most
    at any time)."""
    from glass_tpu_torch.ops import roi_align_rotated as ra

    r, ph, pw, c = g.shape
    units = r * -(-ph // tile[0]) * -(-pw // tile[1])
    trace = torch.zeros(units * K1B_TRACE_STAMPS, dtype=torch.int64, device="cuda")
    out = torch.empty((n_rows, c), dtype=g.dtype, device="cuda")
    acc = out if g.dtype == torch.float32 else torch.empty((n_rows, c), dtype=torch.float32, device="cuda")
    stats = torch.empty(2, dtype=torch.int32, device="cuda")
    flags = ra._unit_flags(out.device, -(-n_rows // ra.UNIT_ROWS))
    info = ra.backward_unit_info(lib, units, "cuda")
    for _ in range(2):
        trace.zero_()
        _checked(lib.study_k1b_trace(
            g.data_ptr(), K1_DTYPES[g.dtype], c, rois.data_ptr(), meta.data_ptr(), levels.data_ptr(),
            grid.data_ptr(), r, ph, pw, tile[0], tile[1], ra.FOOTPRINT_ROWS, ra.SLOT_ROWS, n_rows,
            acc.data_ptr(), out.data_ptr(), flags.data_ptr(), stats.data_ptr(), info.data_ptr(),
            trace.data_ptr(), _stream()))
    torch.cuda.synchronize()
    t = trace.view(units, K1B_TRACE_STAMPS).cpu().numpy().astype(np.float64)
    t = t[(t[:, 0] > 0) & (t[:, 5] > 0)]
    start, end = t[:, 0], t[:, 5]
    dur = end - start
    events = sorted([(x, 1) for x in start] + [(x, -1) for x in end])
    live = most = 0
    for _, d in events:
        live += d
        most = max(most, live)
    full = t[(t[:, 1:5] > 0).all(1)]  # blocks that took the shared path
    phases = {name: float(np.mean(full[:, i + 1] - full[:, i])) if len(full) else 0.0
              for i, name in enumerate(K1B_PHASES)}
    return dict(span_us=(end.max() - start.min()) / 1e3, blocks=len(t),
                block_us=dict(mean=float(dur.mean()) / 1e3, p50=float(np.median(dur)) / 1e3,
                              max=float(dur.max()) / 1e3),
                phase_us={k: v / 1e3 for k, v in phases.items()},
                concurrent=dict(mean=float(dur.sum() / (end.max() - start.min())), most=most))


def study_k1b_scaling(lib, smoke) -> dict:
    """How the shipped K1b's kernels scale at the box pooler's training
    shapes: device ms a call by kernel at 32-256 channels (512 rois) and at
    128-512 rois (256 channels), bf16."""
    from glass_tpu_torch.ops import roi_align_rotated as ra

    h, w = smoke.TRAIN_BUCKET_HW
    results = {}
    for c, n in ((32, 512), (64, 512), (128, 512), (256, 512), (256, 256), (256, 128)):
        rng = np.random.RandomState(7)
        rois = torch.from_numpy(smoke.word_rois(rng, 512, h, w))[:n].cuda()
        sizes = [(-(-h // st), -(-w // st)) for st in smoke.STRIDES]
        meta = ra.pack_pyramid([torch.zeros(a, b, c, dtype=torch.bfloat16, device="cuda") for a, b in sizes],
                               [1.0 / st for st in smoke.STRIDES])
        levels = ra.assign_boxes_to_levels(rois, 2, 6)
        grid = ra.fixed_grid(n, 2, "cuda")
        g = torch.from_numpy(rng.randn(n, 7, 7, c).astype(np.float32)).cuda().to(torch.bfloat16)

        def shipped(g=g, meta=meta, levels=levels, grid=grid):
            return ra.roi_align_rotated_packed_backward(g, meta.meta, rois[:g.shape[0]], levels, grid,
                                                        meta.flat.shape[0], out_dtype=torch.bfloat16)

        if not results:
            print(f"K1b scatter: {lib.study_k1b_occupancy(ra.FOOTPRINT_ROWS, ra.SLOT_ROWS)} blocks an SM "
                  f"resident", flush=True)
        split = kernel_split(shipped)
        if c in (32, 256) and n == 512:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            tr = k1b_trace(lib, g, meta.meta, rois, levels, grid, meta.flat.shape[0],
                           ra.backward_tile(n, (7, 7), sms))
            print(f"K1b box bf16 C={c} R={n} scatter trace: {json.dumps(tr)}", flush=True)
            results[f"K1b box bf16 C={c} R={n} trace"] = tr
        label = f"K1b box bf16 C={c} R={n}"
        results[label] = dict(ms=smoke.kernel_ms(shipped), split=split)
        print(f"{label}: {results[label]['ms']:.4f} ms; by kernel " + ", ".join(
            f"{k.split('k1b')[-1][2:22]} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1])),
            flush=True)
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="chip_smoke_out", help="directory for the JSON and the build log")
    ap.add_argument("--kernels", default="k1,k1b,k2", help="which kernels' alternatives to time")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False; this study needs an NVIDIA GPU")
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    os.makedirs(args.out, exist_ok=True)
    card = smoke.card_line()
    print(card, flush=True)
    lib = build(args.out)
    results = {"card": card}
    for key, study in (("k1", study_k1), ("k1b", study_k1b), ("k1b-scaling", study_k1b_scaling),
                       ("k2", study_k2)):
        if key in kernels:
            results.update(study(lib, smoke))
    with open(os.path.join(args.out, "kernel_variants.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
