"""Upload, ms an image: the program's ``glass.upload`` spans (padding into
the bucket and the copy to the card), over the
traced part of the window (``glass_tpu_torch.utils.trace`` records only
while the profiler runs); None for a program without them."""


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    try:
        from glass_tpu_torch.utils import trace
    except ImportError:
        return None
    span = trace.totals().get("glass.upload")
    return None if not span else span[0] / r.traced_units * 1e3
