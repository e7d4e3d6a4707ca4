"""The render step's share of the card's peak: model FLOPs of the rays
delivered in the traced window (the configuration's reference counts
them per ray) over (window x the published bf16 peak). None on a card
without a published peak."""


def read(run):
    if run.peak is None or not run.rays_window:
        return None
    flops = run.rays_window * run.ref.flops_per_ray(run.cfg)
    return 100.0 * flops / (run.window_s * run.peak["flops_per_s"])
