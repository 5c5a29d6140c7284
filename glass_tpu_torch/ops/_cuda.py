"""Build, load and count the hand-written Hopper kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``.  The build happens at first use, into
``glass_tpu_torch/_build/`` (or ``$GLASS_TPU_TORCH_BUILD_DIR``), keyed by a
hash of the sources and flags so an edited kernel is rebuilt.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

Processes that share the build directory (data-parallel ranks) build one
at a time under a file lock; a library another process built meanwhile is
taken as it is.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds one
(``count``, under a lock: serving replicas launch from threads of their
own) where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
KERNEL_SOURCES = ("roi_align_rotated", "roi_align_rotated_backward", "crop_rois", "paste_masks_rotated")
HEADERS = ("bilinear.cuh",)
# No --use_fast_math, and no FMA contraction: the sample coordinates feed
# floor(), and contracted FMAs move knife-edge samples to the neighbouring
# texel compared with the plain PyTorch version.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def count(name: str) -> None:
    """One launch of kernel ``name``."""
    with _count_lock:
        LAUNCHES[name] += 1


def build_dir() -> str:
    return os.environ.get("GLASS_TPU_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(CSRC), "_build"
    )


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in (f"{name}.cu",) + HEADERS:
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    out = _library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on the build directory, held across processes
    (released by the kernel if the holder dies)."""
    os.makedirs(build_dir(), exist_ok=True)
    with open(os.path.join(build_dir(), ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names=KERNEL_SOURCES) -> dict:
    """Compile every named source in parallel.  Returns {name: (seconds,
    compiler log)}; raises if any build fails."""
    with _build_lock():
        return _build_all(names)


def _build_all(names) -> dict:
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    logs, failed = {}, []
    for n, job in started.items():
        if job is None:
            logs[n] = (0.0, "already built")
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        logs[n] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(_library_path(name))
            _libs[name] = lib
        return lib


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {status}")
