"""Kernel K1's share of its roofline, %: the least time of its calls
in the traced part (bytes and operations from the calls' shapes and rois,
``harness/roofline.py``) over the device time of its records."""

from benchmark.harness import roofline


def read(r):
    if r.trace is None:
        return None
    return roofline.share(r.launches.get("k1", []), "k1", r.trace)
