"""The backlog a view finds when it is admitted, in tiles: the queue's
rays still to coalesce over the tile size, rounded up, plus the tiles in
flight; the mean over the views admitted in the window (the engine's
``backlog_tiles_at_admit`` over ``admitted_views``, as deltas). None
without the counters (a program without them)."""


def read(run):
    if "admitted_views" not in run.stats1:
        return None
    views = run.stats1["admitted_views"] - run.stats0["admitted_views"]
    if views <= 0:
        return None
    return (run.stats1["backlog_tiles_at_admit"]
            - run.stats0["backlog_tiles_at_admit"]) / views
