"""The median ``GlassRunner.__call__`` latency, ms, over every request of
the window's untraced part: the steadier statistic beside the p90."""

import statistics


def read(r):
    return statistics.median(r.latencies_s) * 1e3 if r.latencies_s else None
