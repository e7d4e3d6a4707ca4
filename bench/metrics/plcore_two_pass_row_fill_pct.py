"""Share of K2's MMA rows that held real samples: the engine's
``plcore_two_pass_rows_real`` over ``plcore_two_pass_rows_mma``, as deltas
over the window, counted by K2's traced instance in every tile drained
(rows past a ray's samples in a chunk are padding; a tile's padded rays
count as real). None without the counters (a program without them)."""

REAL = "plcore_two_pass_rows_real"
MMA = "plcore_two_pass_rows_mma"


def read(run):
    if REAL not in run.stats1 or MMA not in run.stats1:
        return None
    mma = run.stats1[MMA] - run.stats0[MMA]
    if mma <= 0:
        return None
    return 100.0 * (run.stats1[REAL] - run.stats0[REAL]) / mma
