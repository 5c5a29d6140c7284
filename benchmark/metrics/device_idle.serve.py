"""The card's idle share of the traced part of the window, %: no kernel
and no copy running, from the profiler's device records."""


def read(r):
    if r.trace is None or not r.trace.window_s:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
