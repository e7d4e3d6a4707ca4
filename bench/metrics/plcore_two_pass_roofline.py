"""K2's share of its roofline: the least time its launches could take for
their real rays (model FLOPs at the peak, or bytes at the memory's rate,
whichever is larger, as the configuration's reference counts them:
``work.least_seconds``), over the device time of those launches in the
profiler's trace. The launches are every tile the traced run coalesced,
one K2 launch each; None when the trace's launches do not match them one
for one."""
from bench import work


def read(run):
    if run.device is None or run.peak is None:
        return None
    times = run.device["kernel_s"].get("plcore_two_pass", [])
    if not times or len(times) != len(run.coalesced_rays):
        return None
    least = sum(work.least_seconds(run.ref, run.cfg, n, run.peak)
                for n in run.coalesced_rays)
    return 100.0 * least / sum(times)
