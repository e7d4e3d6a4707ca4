"""Median latency, due time to last pixel scattered, over every view due in
the window; one never delivered counts as the time it was waited for."""
from bench.traffic import nearest_rank


def read(run):
    v = nearest_rank(run.latencies_s, 0.50)
    return None if v is None else 1e3 * v
