"""Compile-and-load for the native polygon library.

``polyclip.cpp`` is compiled with ``g++`` at first use into
``glass_tpu_torch/_build/`` (or ``$GLASS_TPU_TORCH_BUILD_DIR``), never beside
the source, under a name keyed by a hash of the source and the flags, and
loaded with ``ctypes``.  When the build or the load fails, the evaluator
takes its pure-Python polygon path and a warning says so;
``polyclip_path()`` names the path that ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "polyclip.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_path = None  # "native" or "python" once load_polyclip has run


def build_dir() -> str:
    return os.environ.get("GLASS_TPU_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_HERE), "_build"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir(), f"libpolyclip-{h.hexdigest()[:16]}.so")


class PolyClip:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        d = ctypes.POINTER(ctypes.c_double)
        i = ctypes.POINTER(ctypes.c_int32)
        lib.polyclip_intersection_area.restype = ctypes.c_double
        lib.polyclip_intersection_area.argtypes = [d, ctypes.c_int, d, ctypes.c_int]
        lib.polyclip_area.restype = ctypes.c_double
        lib.polyclip_area.argtypes = [d, ctypes.c_int]
        lib.polyclip_pairwise_iou.restype = None
        lib.polyclip_pairwise_iou.argtypes = [d, i, ctypes.c_int32, d, i, ctypes.c_int32, d]
        lib.polyclip_pairwise_ioa_first.restype = None
        lib.polyclip_pairwise_ioa_first.argtypes = [d, i, ctypes.c_int32, d, i, ctypes.c_int32, d]

    @staticmethod
    def _flatten(polys):
        offsets = np.zeros(len(polys) + 1, np.int32)
        for k, p in enumerate(polys):
            offsets[k + 1] = offsets[k] + len(p)
        coords = (
            np.concatenate([np.asarray(p, np.float64).reshape(-1, 2) for p in polys])
            if polys
            else np.zeros((0, 2))
        )
        return np.ascontiguousarray(coords, np.float64), offsets

    def intersection_area(self, p: np.ndarray, q: np.ndarray) -> float:
        p = np.ascontiguousarray(np.asarray(p, np.float64).reshape(-1, 2))
        q = np.ascontiguousarray(np.asarray(q, np.float64).reshape(-1, 2))
        return self._lib.polyclip_intersection_area(
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(p),
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(q),
        )

    def area(self, p: np.ndarray) -> float:
        p = np.ascontiguousarray(np.asarray(p, np.float64).reshape(-1, 2))
        return self._lib.polyclip_area(
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(p)
        )

    def _pairwise(self, fn, polys_p, polys_q) -> np.ndarray:
        cp, op = self._flatten(polys_p)
        cq, oq = self._flatten(polys_q)
        out = np.zeros((len(polys_p), len(polys_q)), np.float64)
        if out.size:
            fn(
                cp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                op.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(polys_p),
                cq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                oq.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(polys_q),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
        return out

    def pairwise_iou(self, polys_p, polys_q) -> np.ndarray:
        return self._pairwise(self._lib.polyclip_pairwise_iou, polys_p, polys_q)

    def pairwise_ioa_first(self, polys_p, polys_q) -> np.ndarray:
        """intersection / area(p_i) — detection coverage by don't-cares."""
        return self._pairwise(self._lib.polyclip_pairwise_ioa_first, polys_p, polys_q)


def _build(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC], check=True, capture_output=True)
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    logger.info("built native polyclip: %s", out)


def load_polyclip():
    """Build (if needed) and load the native library; None on failure."""
    global _lib, _path
    with _lock:
        if _path is not None:
            return _lib
        try:
            out = library_path()
            if not os.path.exists(out):
                _build(out)
            _lib = PolyClip(ctypes.CDLL(out))
            _path = "native"
        except (OSError, subprocess.CalledProcessError) as e:  # no g++, or it failed
            logger.warning("native polyclip unavailable (%s); using the python path", e)
            _lib, _path = None, "python"
        return _lib


def polyclip_path() -> str:
    """Which polygon path the evaluator takes: "native" or "python"."""
    load_polyclip()
    return _path
