"""Kernel launches an image: the profiler's kernel records (copies and
memsets left out) in the traced part of the window, over its images."""


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    kernels = r.trace.kernels(lambda n: not n.startswith(("Memcpy", "Memset")))
    return len(kernels) / r.traced_units
