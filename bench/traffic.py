"""The traffic generator and the two loops that drive the engine.

A mix is a JSON file of parameters (``bench/traffic/<name>.json``):

* ``loop``: ``"closed"`` (``clients`` callers, each sending its next view
  when its last one completes) or ``"open"`` (views due at ``rate_rps``,
  sent when due whether or not the engine kept up);
* ``hw``: the view sides, drawn uniformly; ``scenes``: the resident
  scenes, drawn uniformly or, with ``zipf_s`` > 0, with popularity
  1 / rank^s; ``theta`` and ``phi``: the ranges of the orbit pose, in
  degrees; ``radius``: the camera's distance.

The work a seed gets does not depend on it. Views come in blocks of
``BLOCK``: in each block every side and every scene appears a fixed number
of times (its share, rounded by largest remainder), in an order drawn from
the seed; the open loop's gaps are, block by block, the exponential
distribution's quantiles at (k + 0.5) / BLOCK, also in an order drawn from
the seed. The seed moves the order, the scenes' poses and so the images,
not the amount of work or the offered load.

A mix with ``trace_seed`` replays one schedule: the order of the sides,
the scenes and the open loop's gaps is drawn from ``trace_seed`` alone, so
every run seed sends the same views at the same times, and the seed draws
only the poses (and the scenes' weights). An open loop's latency tail at
four fifths of capacity is set by the few bursts of its schedule, so under
a schedule that moves with the seed it measures the draw and not the system.

The loops (after ``serving/loadgen.py``'s ``run_closed_loop`` and
``run_open_loop``) run for a fixed window and then stop sending, and wait
until every view sent in the window has an answer, a minute past the
window at the most. Latency is taken from when a view was due (open) or
sent (closed) to when its last pixel was scattered; the lateness of the
sender is kept apart.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

BLOCK = 64
#: how long past the window the loops wait for the views sent in it
DRAIN_LIMIT_S = 60.0


@dataclass(frozen=True)
class View:
    scene: int
    hw: int
    theta: float
    phi: float
    radius: float


@dataclass
class Sent:
    """One view sent in the window: when it was due and when it went out,
    on the engine's clock, and the engine's request id."""
    view: View
    rid: int
    due: float
    sent: float


def scene_shares(traffic: dict) -> np.ndarray:
    n, s = int(traffic["scenes"]), float(traffic.get("zipf_s", 0.0))
    w = np.arange(1, n + 1, dtype=np.float64) ** -s
    return w / w.sum()


def quota(shares: np.ndarray, total: int) -> np.ndarray:
    """Counts summing to ``total`` in proportion to ``shares``: floors,
    then one more to the largest remainders."""
    exact = np.asarray(shares, np.float64) * total
    counts = np.floor(exact).astype(np.int64)
    rest = total - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:rest]] += 1
    return counts


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def views(traffic: dict, seed: int) -> Iterator[View]:
    """The views of the mix, endlessly, in blocks of ``BLOCK``."""
    rng = _rng(seed, 1)
    order = (_rng(int(traffic["trace_seed"]), 1) if "trace_seed" in traffic
             else rng)
    hws = [int(h) for h in traffic["hw"]]
    th, ph = traffic.get("theta", [0.0, 360.0]), traffic.get("phi",
                                                             [-35.0, -15.0])
    radius = float(traffic.get("radius", 4.0))
    sides = np.repeat(hws, quota(np.full(len(hws), 1 / len(hws)), BLOCK))
    scenes = np.repeat(np.arange(int(traffic["scenes"])),
                       quota(scene_shares(traffic), BLOCK))
    while True:
        side_order = order.permutation(sides)
        scene_order = order.permutation(scenes)
        for k in range(BLOCK):
            yield View(int(scene_order[k]), int(side_order[k]),
                       float(rng.uniform(th[0], th[1])),
                       float(rng.uniform(ph[0], ph[1])), radius)


def arrivals(traffic: dict, seed: int, seconds: float,
             rate_rps: Optional[float] = None) -> List[float]:
    """Due times in [0, seconds) of the open loop, in seconds."""
    rate = float(traffic["rate_rps"] if rate_rps is None else rate_rps)
    q = (np.arange(BLOCK) + 0.5) / BLOCK
    gaps = -np.log1p(-q) / rate
    rng = _rng(int(traffic.get("trace_seed", seed)), 2)
    out, t = [], 0.0
    while True:
        for g in rng.permutation(gaps):
            t += float(g)
            if t >= seconds:
                return out
            out.append(t)


class ScatterLog:
    """What ``CompletionSink.scatter`` handed back, tile by tile, read on
    the benchmark's clock as each scatter returns: (time, real rays), and
    the time each view's last pixel landed (``done_at``, by request id).
    Wraps the sink's bound method of one engine."""

    def __init__(self, engine, clock):
        self.times: List[float] = []
        self.real: List[int] = []
        self.done_at: Dict[int, float] = {}
        sink = engine.completion
        scatter = sink.scatter

        def logged(tile, rgb):
            seen = len(sink.completion_order)
            scatter(tile, rgb)
            now = clock()
            self.times.append(now)
            self.real.append(int(tile.n_real))
            for rid in sink.completion_order[seen:]:
                self.done_at[rid] = now
        sink.scatter = logged

    def rays_between(self, t0: float, t1: float) -> int:
        return sum(r for t, r in zip(self.times, self.real) if t0 <= t <= t1)


@dataclass
class Window:
    """One measured window: its bounds on the engine's clock (``t1`` the
    planned close, ``t_stop`` when the loop saw it), the views sent in it
    and the engine's stats at both ends."""
    t0: float
    t1: float
    t_stop: float
    sent: List[Sent]
    stats0: dict
    stats1: dict


def _drain(engine, sent: List[Sent], t_close: float, clock) -> None:
    while (any(s.rid not in engine.completed for s in sent)
           and clock() < t_close + DRAIN_LIMIT_S):
        if not engine.step():
            break


def _nothing() -> None:
    pass


def run_closed(engine, make_request, stream: Iterator[View], clients: int,
               seconds: float, clock=time.perf_counter, on_open=_nothing,
               on_close=_nothing) -> Window:
    """``clients`` callers for ``seconds``; each sends its next view as its
    last one completes. ``on_open`` runs just before the window opens,
    ``on_close`` as the loop sees it closed, before the drain."""
    sent: List[Sent] = []
    on_open()
    stats0 = dict(engine.stats)
    t0 = clock()
    t1 = t0 + seconds
    while clock() < t1:
        while engine.pending < clients:
            v = next(stream)
            now = clock()
            sent.append(Sent(v, engine.submit(make_request(v)), now, now))
        engine.step()
    t_stop = clock()
    stats1 = dict(engine.stats)
    on_close()
    _drain(engine, sent, t1, clock)
    return Window(t0, t1, t_stop, sent, stats0, stats1)


def run_open(engine, make_request, stream: Iterator[View], due: List[float],
             seconds: float, clock=time.perf_counter, sleep=time.sleep,
             on_open=_nothing, on_close=_nothing) -> Window:
    """Views due at ``due`` (seconds into the window), each sent once its
    time has passed; after the window nothing more is due, and the engine
    drains. ``on_open`` and ``on_close`` as in ``run_closed``."""
    sent: List[Sent] = []
    on_open()
    stats0 = dict(engine.stats)
    t0 = clock()
    t1 = t0 + seconds
    i, t_stop, stats1 = 0, None, None
    while i < len(due) or engine.pending:
        now = clock()
        while i < len(due) and t0 + due[i] <= now:
            v = next(stream)
            sent.append(Sent(v, engine.submit(make_request(v)), t0 + due[i],
                             clock()))
            i += 1
        if t_stop is None and now >= t1:
            t_stop, stats1 = now, dict(engine.stats)
            on_close()
        if now > t1 + DRAIN_LIMIT_S:
            break
        if not engine.step() and i < len(due):
            sleep(max(0.0, min(t0 + due[i] - clock(), 0.002)))
    if t_stop is None:
        # every view was answered before the window closed: idle to it
        sleep(max(0.0, t1 - clock()))
        t_stop, stats1 = clock(), dict(engine.stats)
        on_close()
    return Window(t0, t1, t_stop, sent, stats0, stats1)


def nearest_rank(values: List[float], q: float) -> Optional[float]:
    """The q-quantile (0 < q <= 1) by nearest rank, or None when empty."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]
