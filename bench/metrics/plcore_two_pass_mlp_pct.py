"""K2's share of its cycles in the MLP layers (their wgmma steps, epilogues
and barriers; the waits for the weight ring's bytes are not in it): the
engine's ``plcore_two_pass_cycles_mlp`` over
``plcore_two_pass_cycles_total``, as deltas over the window, counted by
K2's traced instance in every tile drained. None without the counters (a
program without them)."""

PHASE = "plcore_two_pass_cycles_mlp"
TOTAL = "plcore_two_pass_cycles_total"


def read(run):
    if PHASE not in run.stats1 or TOTAL not in run.stats1:
        return None
    total = run.stats1[TOTAL] - run.stats0[TOTAL]
    if total <= 0:
        return None
    return 100.0 * (run.stats1[PHASE] - run.stats0[PHASE]) / total
