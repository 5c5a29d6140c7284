"""Device time of design alternatives of kernels K1 and K2 beside the
shipped kernels, at the main-path shapes of ``chip_smoke.py`` phases 2-3.

    python3 -m glass_tpu_torch.study.kernel_variants [--out DIR]

run from the root of the repo on one GPU.  It builds ``kernel_variants.cu``
(which includes both kernels' sources) with the port's nvcc flags into the
port's build directory, and compares with the shipped kernel, each case on
the same inputs:

  K1, at the box, mask and recognizer poolers (f32 and bf16) and the mask
      pooler with every roi on the full 4x4 grid: other tiles of bins than
      the shipped band of all bin rows by max(2, 16 // rows) columns;
  K2, for uint8 with the fold, f32 and bf16 at sampling ratios 1, 2 and 0:
      1, 2, 4 and 8 output rows a block (shipped: 3); the roi frame computed
      once a block into shared memory behind a barrier (shipped: in every
      thread); a run of 16 bytes' worth of pixels a thread written as
      16-byte stores (shipped: one pixel a thread, three scalar stores).

Every alternative's output must equal the shipped kernel's bit for bit.
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
    for fn in (lib.study_roi_align_tile, lib.study_crop_rows, lib.study_crop_variant):
        fn.restype = i
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _checked(status: int) -> None:
    if status != 0:
        raise RuntimeError(f"study kernel launch failed with cudaError {status}")


def compare(label: str, launches: dict, kernel_ms) -> dict:
    """Device times of each launch in ``launches`` (the first is the shipped
    kernel), after checking each output equals the first's bit for bit."""
    ref = next(iter(launches.values()))()
    for name, fn in launches.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="chip_smoke_out", help="directory for the JSON and the build log")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False; this study needs an NVIDIA GPU")
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    os.makedirs(args.out, exist_ok=True)
    card = smoke.card_line()
    print(card, flush=True)
    lib = build(args.out)
    results = {"card": card, **study_k1(lib, smoke), **study_k2(lib, smoke)}
    with open(os.path.join(args.out, "kernel_variants.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
