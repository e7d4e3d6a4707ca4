"""The scheduler's padding: padded rays over all rays of the tiles it
coalesced in the window (the engine's counters, as a delta)."""


def read(run):
    pad = run.stats1["padded_rays"] - run.stats0["padded_rays"]
    real = run.stats1["rays_rendered"] - run.stats0["rays_rendered"]
    if pad + real <= 0:
        return None
    return 100.0 * pad / (pad + real)
