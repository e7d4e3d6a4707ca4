"""Synthetic serving client: deterministic Poisson traces and two drive
modes against a ``RenderEngine``.

* ``poisson_trace`` — N requests with exponential inter-arrival gaps (rate
  in req/s), scene ids drawn uniformly, mixed resolutions and priorities,
  everything from one ``np.random.RandomState(seed)`` drawn in the
  reference package's order, so the same seed gives the same trace there
  and here.
* ``run_open_loop`` — arrival-time-faithful: requests are injected when
  their wall-clock arrival passes, whether or not the engine kept up, so
  queueing delay shows in the tail latencies.
* ``run_closed_loop`` — fixed concurrency, the next request submitted as
  one completes; arrival times are ignored. Deterministic step count.

Both report throughput (req/s, rays/s), p50/p95/p99 request latency split
into ``queueing_ms`` (submit or arrival until the first ray is tiled) and
``service_ms`` (first ray tiled until the last pixel scatters), the engine
and scene-cache counters (dispatch savings against the per-request
baseline, cache hit rate) and the robustness block
(``RenderEngine.robustness``). Latency percentiles cover delivered
requests only.

Multi-host mode: ``run_trace(..., host_events=[...])`` arms ``HostEvent``
schedules (kills and slow-downs at trace-time offsets or dispatch counts) on
a ``ClusterEngine`` before driving it; ``overload_host_events`` builds the
canonical mid-trace kill + early slow-down mix. A cluster's report gains a
``cluster`` block (per-host state, dispatches and goodput proxy, cross-host
redispatches, quarantine counts).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.cluster import HostEvent
from repro_torch.serving.engine import (RenderEngine, RenderRequest,
                                        RenderResult)


@dataclass(frozen=True)
class TraceItem:
    arrival_s: float
    request: RenderRequest


def poisson_trace(n_requests: int, scene_ids: Sequence[str],
                  rate_rps: float = 50.0,
                  hw_choices: Sequence[int] = (16, 32),
                  priorities: Sequence[int] = (0,),
                  deadline_choices: Sequence[Optional[float]] = (None,),
                  seed: int = 0) -> List[TraceItem]:
    """Open-loop arrival trace: a Poisson process at ``rate_rps`` over
    uniformly drawn scenes, resolutions, priorities and per-request
    deadlines (seconds from submit, or ``None`` for no SLO).
    Deterministic in ``seed``."""
    rng = np.random.RandomState(seed)
    items, t = [], 0.0
    for _ in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        dl = deadline_choices[int(rng.randint(len(deadline_choices)))]
        items.append(TraceItem(t, RenderRequest(
            scene_id=scene_ids[int(rng.randint(len(scene_ids)))],
            hw=int(hw_choices[int(rng.randint(len(hw_choices)))]),
            theta=float(rng.uniform(0.0, 360.0)),
            phi=float(rng.uniform(-35.0, -15.0)),
            priority=int(priorities[int(rng.randint(len(priorities)))]),
            deadline_s=None if dl is None else float(dl))))
    return items


def overload_host_events(n_hosts: int, trace_wall_s: float,
                         *, kill_frac: float = 0.4,
                         slow_frac: float = 0.15,
                         slow_extra_s: float = 0.05,
                         seed: int = 0) -> List[HostEvent]:
    """The canonical multi-host overload schedule for a trace expected to
    span ``trace_wall_s``: one host turns SLOW early (``slow_frac`` of the
    trace; the health layer should flag it suspect) and a DIFFERENT host
    is killed mid-trace (``kill_frac``; its in-flight tiles must fail
    over). The host choice is seeded; with one host only the slow event
    remains (killing the only host rejects the tail, another scenario)."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    rng = np.random.RandomState(seed)
    victim = int(rng.randint(n_hosts))
    slow = victim
    if n_hosts > 1:
        # (the reference draws randint(0) here for one host, and raises)
        slow = int(rng.randint(n_hosts - 1))
        slow = slow if slow < victim else slow + 1    # not the victim
    events = [HostEvent("slow", slow,
                        at_s=slow_frac * trace_wall_s,
                        extra_s=slow_extra_s)]
    if n_hosts > 1:
        events.append(HostEvent("kill", victim,
                                at_s=kill_frac * trace_wall_s))
    return events


def _percentiles_ms(latencies_s: Sequence[float]) -> dict:
    if not latencies_s:
        return {"p50": None, "p95": None, "p99": None}
    ms = np.asarray(latencies_s) * 1e3
    return {p: round(float(np.percentile(ms, q)), 3)
            for p, q in (("p50", 50), ("p95", 95), ("p99", 99))}


def _report(engine: RenderEngine, latencies_s: List[float],
            wall_s: float, mode: str,
            queueing_s: Sequence[float] = (),
            service_s: Sequence[float] = ()) -> dict:
    st = dict(engine.stats)
    rb = engine.robustness()
    n_delivered = (rb["status_counts"].get("ok", 0)
                   + rb["status_counts"].get("degraded", 0))
    out = {
        "mode": mode,
        "requests_completed": st["requests_completed"],
        "requests_delivered": n_delivered,
        "goodput": rb["goodput"],
        "wall_s": round(wall_s, 4),
        # throughput counts DELIVERED requests: a rejected request took
        # no engine work
        "req_per_s": round(n_delivered / wall_s, 2) if wall_s > 0 else None,
        "rays_per_s": round(st["rays_rendered"] / wall_s, 1)
        if wall_s > 0 else None,
        "latency_ms": _percentiles_ms(latencies_s),
        "queueing_ms": _percentiles_ms(queueing_s),
        "service_ms": _percentiles_ms(service_s),
        "engine": st,
        "robustness": rb,
        "dispatch_savings": st["dispatch_baseline"] - st["dispatches"],
        "cache": engine.cache.stats(),
    }
    if hasattr(engine, "cluster_stats"):
        out["cluster"] = engine.cluster_stats()
    if engine.tracer.enabled:
        out["observability"] = engine.tracer.summary()
    return out


def _delivered(results: List[RenderResult]) -> List[RenderResult]:
    return [r for r in results if r.delivered]


def run_open_loop(engine: RenderEngine, trace: List[TraceItem], *,
                  clock=time.perf_counter, sleep=time.sleep) -> dict:
    """Wall-clock open loop: each request is submitted once its arrival
    time has passed; latency = completion - arrival (queueing included),
    split at the first-ray-tiled timestamp. Idles sleep until the next
    arrival. ``clock``/``sleep`` are injectable."""
    t0 = clock()
    arrivals = {}           # rid -> absolute arrival time
    i = 0
    while i < len(trace) or engine.pending:
        now = clock() - t0
        while i < len(trace) and trace[i].arrival_s <= now:
            rid = engine.submit(trace[i].request)
            arrivals[rid] = t0 + trace[i].arrival_s
            i += 1
        if not engine.step() and i < len(trace):
            sleep(max(0.0, min(trace[i].arrival_s - (clock() - t0),
                               0.05)))
    wall = clock() - t0
    done = [(engine.completed[rid], t_arr)
            for rid, t_arr in arrivals.items() if rid in engine.completed]
    done = [(res, t_arr) for res, t_arr in done if res.delivered]
    lats = [res.complete_s - t_arr for res, t_arr in done]
    queueing = [max(0.0, res.service_start_s - t_arr) for res, t_arr in done]
    service = [res.service_s for res, _ in done]
    return _report(engine, lats, wall, "open", queueing, service)


def run_closed_loop(engine: RenderEngine, trace: List[TraceItem],
                    concurrency: int = 4, *,
                    clock=time.perf_counter) -> dict:
    """Closed loop at fixed concurrency: arrival times ignored, the next
    trace request enters as one in flight completes; latency = completion
    - submit, split at the first-ray-tiled timestamp."""
    t0 = clock()
    i, done0 = 0, len(engine.completion_order)
    while i < len(trace) or engine.pending:
        while i < len(trace) and engine.pending < concurrency:
            engine.submit(trace[i].request)
            i += 1
        engine.step()
    wall = clock() - t0
    done = _delivered([engine.completed[rid]
                       for rid in engine.completion_order[done0:]])
    return _report(engine, [r.latency_s for r in done], wall, "closed",
                   [r.queueing_s for r in done],
                   [r.service_s for r in done])


def run_trace(engine: RenderEngine, trace: List[TraceItem], *,
              mode: str = "open", concurrency: int = 4,
              clock=time.perf_counter, sleep=time.sleep,
              host_events: Optional[List[HostEvent]] = None) -> dict:
    """Drive one trace in ``mode`` ``"open"`` or ``"closed"``.
    ``host_events`` arms kill / slow / drain / rejoin schedules on a
    cluster engine; a single-host engine refuses them (it has no hosts to
    kill)."""
    if host_events:
        if not hasattr(engine, "schedule_host_events"):
            raise ValueError("host_events requires a ClusterEngine "
                             "(single-host engines have no hosts to kill)")
        engine.schedule_host_events(list(host_events))
    if mode == "open":
        return run_open_loop(engine, trace, clock=clock, sleep=sleep)
    if mode == "closed":
        return run_closed_loop(engine, trace, concurrency, clock=clock)
    raise ValueError(f"unknown loadgen mode: {mode!r}")
