"""Share of the window in which the engine's thread waited on the card:
the engine's ``host_wait_s`` (the drain's wait for a tile's pixels, the
loop's only wait on the card) as a delta over the window, over the
window's length. None without the counter (a program without it)."""


def read(run):
    if "host_wait_s" not in run.stats1 or run.window_s <= 0:
        return None
    return 100.0 * (run.stats1["host_wait_s"]
                    - run.stats0["host_wait_s"]) / run.window_s
