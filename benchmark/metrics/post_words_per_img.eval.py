"""Words entering the host stage, an image: the program's
``glass.post.words`` counter, counted at each ``glass.post``'s start, over
the traced part of the window (``glass_tpu_torch.utils.trace`` records
only while the profiler runs); None for a program without it.  A count of
work, which an exact change leaves as it is."""


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    try:
        from glass_tpu_torch.utils import trace
    except ImportError:
        return None
    n = trace.totals().get("glass.post.words")
    return None if n is None else n / r.traced_units
