"""The render step's share of the card's peak: model FLOPs of the rays
delivered in the traced window over (window x the published bf16 peak).
None on a card without a published peak."""
from bench import work


def read(run):
    if run.peak is None or not run.rays_window:
        return None
    flops = run.rays_window * work.flops_per_ray(run.cfg)
    return 100.0 * flops / (run.window_s * run.peak["flops_per_s"])
