"""Resize, ms an image: the program's ``glass.resize`` spans (the colour
order, ``cv2.resize`` and the cast, on the calling thread), over the
traced part of the window (``glass_tpu_torch.utils.trace`` records only
while the profiler runs); None for a program without them."""


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    try:
        from glass_tpu_torch.utils import trace
    except ImportError:
        return None
    span = trace.totals().get("glass.resize")
    return None if not span else span[0] / r.traced_units * 1e3
