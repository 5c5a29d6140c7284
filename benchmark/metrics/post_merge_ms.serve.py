"""The merge fixpoint, ms an image: the program's ``glass.post.merge``
spans (``merge_intersecting_boxes``, on the host or the card), over the
traced part of the window (``glass_tpu_torch.utils.trace`` records only
while the profiler runs); None for a program without them."""


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    try:
        from glass_tpu_torch.utils import trace
    except ImportError:
        return None
    span = trace.totals().get("glass.post.merge")
    return None if not span else span[0] / r.traced_units * 1e3
