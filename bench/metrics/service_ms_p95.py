"""The 95th percentile of service, first ray tiled to last pixel
scattered, over the delivered views due in the window."""
from bench.traffic import nearest_rank


def read(run):
    v = nearest_rank(run.service_s, 0.95)
    return None if v is None else 1e3 * v
