"""The board's energy over the window (NVML), in microjoules, over the
samples of the rays scattered in it: 2 x n_coarse + n_fine per ray, as
``serve`` counts them. None without the counter (a traced run)."""
from bench import work


def read(run):
    if run.energy_j is None or not run.rays_energy:
        return None
    return run.energy_j * 1e6 / (run.rays_energy
                                 * work.samples_per_ray(run.cfg))
