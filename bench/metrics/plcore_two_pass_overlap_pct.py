"""Share of K2's k steps that a warpgroup issued while its previous step
was still in flight (the pipelined k loop): the engine's
``plcore_two_pass_steps_overlapped`` over ``plcore_two_pass_steps_mma``,
as deltas over the window, counted by K2's traced instance in every tile
drained. 0 where K2's loop waits for each step; None without the counters
(a program without them) or without a traced K2 launch in the window."""

OVERLAPPED = "plcore_two_pass_steps_overlapped"
STEPS = "plcore_two_pass_steps_mma"


def read(run):
    if OVERLAPPED not in run.stats1 or STEPS not in run.stats1:
        return None
    steps = run.stats1[STEPS] - run.stats0[STEPS]
    if steps <= 0:
        return None
    return 100.0 * (run.stats1[OVERLAPPED] - run.stats0[OVERLAPPED]) / steps
