"""Rounds of the merge fixpoint, an image: the program's
``glass.post.merge.rounds`` counter, added once a
``merge_intersecting_boxes`` call, over the traced part of the window
(``glass_tpu_torch.utils.trace`` records only while the profiler runs);
None for a program without it.  A count of work, which an exact change
leaves as it is: it tells a slower merge from a merge with more rounds."""


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    try:
        from glass_tpu_torch.utils import trace
    except ImportError:
        return None
    n = trace.totals().get("glass.post.merge.rounds")
    return None if n is None else n / r.traced_units
