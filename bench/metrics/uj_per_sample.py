"""The board's energy over the window (NVML), in microjoules, over the
samples of the rays scattered in it: the configuration's reference counts
them per ray (2 x n_coarse + n_fine for NeRF, as ``serve`` counts them).
None without the counter (a traced run)."""


def read(run):
    if run.energy_j is None or not run.rays_energy:
        return None
    return run.energy_j * 1e6 / (run.rays_energy
                                 * run.ref.samples_per_ray(run.cfg))
