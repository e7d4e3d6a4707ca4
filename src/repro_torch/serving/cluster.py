"""Multi-host serving fabric: a ``HostPool`` behind one global scheduler.

ICARUS scales rendering by replicating self-contained PLCores, each owning
its pipeline end to end. Where state is replicable, work is cheaply
redirectable. The serving counterpart: a pool of **hosts**, each an
isolated ``TileExecutor`` + ``SceneCache`` over its own group of devices
(``split_devices``), fronted by ONE global ``ClusterScheduler`` whose
placement decision folds scene-cache residency and shard locality into
the same score. ``ClusterEngine`` keeps the ``RenderEngine`` facade
(submit / step / drain / take), and ``hosts=1`` is the single-host engine.

On one card every host's group is the card itself (``split_devices`` gives
every host the full list when there are fewer devices than hosts): host
isolation then lives in the caches, the executors and the health state,
and every host's tiles run K2 on the same stream. Over a cell list that
names one card several times (``runtime.sharding.plcore_mesh``) each host
gets a disjoint group of cells, each cell with its own CUDA stream.

Every single-host robustness policy has its cross-host version:

* **Host health.** Each host carries a heartbeat (stamped on every
  dispatch and drain) and a per-host service EWMA (fed to
  ``StragglerMonitor.record_host_step``; ``slow_hosts()`` flags hosts
  slower than ``slow_factor`` x the median). States: ``healthy ->
  suspect`` (flagged slow, or a stale heartbeat with tiles in flight)
  ``-> dead`` (heartbeat timeout or kill event), plus ``draining``
  (graceful exit) and rejoin. Seeded ``FaultPlan`` host event sites
  (``draw_host_event``) inject kills and slow-downs from per-host streams.
* **Cross-host failover.** A tile that fails on host A (a dispatch raise
  or a corrupt drain) is first redispatched synchronously to a DIFFERENT
  healthy host through the executor's ``redispatch_hook``, bit for bit,
  because every host packs the same weights; only when no other host can
  serve it does the local retry -> oracle ladder run, as the last rung. A
  killed host's in-flight tiles are re-queued and re-placed (their rays
  were already handed out, so re-queueing tiles, not rewinding requests,
  keeps every submit answered exactly once). Their work on the card is
  dropped without a wait (``TileExecutor.abandon_all``).
* **Per-host scene quarantine.** A scene whose loader fails
  ``max_load_failures`` times in a row on host A is quarantined *on A*
  and routed to B instead of being declared dead. Quarantine windows
  count down per scheduling call; at zero the next placement is a
  recovery probe: success lifts the quarantine, failure re-arms it. Only
  when EVERY placeable host has the scene quarantined are its queued
  requests terminated.
* **Aggregate SLO admission.** The predicted queueing delay divides the
  global backlog by the pool's aggregate service rate (each host adds
  ``health_weight / service_ewma``: healthy 1.0, suspect 0.5), so a
  degraded pool admits less and a pool with no placeable host admits
  nothing.
* **Drain / rejoin.** Draining a host stops new placements, migrates its
  cached-scene affinity to live hosts (a placement bonus on the new host;
  unpinned residents discarded) and lets in-flight tiles finish; rejoin
  restores placement eligibility.
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.metrics import CLUSTER_STATS_SCHEMA, extend_stats_view
from repro_torch.serving.engine import (RenderEngine, TileExecutor,
                                        TileScheduler, _Tile)
from repro_torch.serving.scene_cache import SceneCache, SceneLoadError

#: Host lifecycle states (see module docstring).
HOST_STATES = ("healthy", "suspect", "draining", "dead")


def split_devices(n_hosts: int, devices: Optional[list] = None) -> List[list]:
    """Partition devices into contiguous per-host groups: eight cells
    split 4 + 4 across two hosts, each group backing its own cell list.
    ``devices`` defaults to every visible card. With fewer devices than
    hosts every host shares the full list (isolation is then exercised at
    the cache and executor layer, not the device layer)."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: pass the "
                               "devices (e.g. ['cpu']) explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if len(devs) < n_hosts:
        return [list(devs) for _ in range(n_hosts)]
    per = len(devs) // n_hosts
    return [devs[i * per:(i + 1) * per] for i in range(n_hosts)]


@dataclass
class HostEvent:
    """One scheduled host-level event. ``at_s`` fires at an engine-clock
    offset from engine start; ``at_dispatch`` fires once the engine's
    global dispatch counter reaches the value (clockless, deterministic);
    with neither, the event fires on the next step. ``extra_s`` only
    matters for ``slow``."""
    kind: str                          # kill | slow | drain | rejoin | hang
    host: int
    at_s: Optional[float] = None
    at_dispatch: Optional[int] = None
    extra_s: float = 0.25

    def __post_init__(self):
        if self.kind not in ("kill", "slow", "drain", "rejoin", "hang"):
            raise ValueError(f"unknown host event kind {self.kind!r}")


class Host:
    """One pool member: an isolated SceneCache + TileExecutor (over its
    own device group) plus the health state the cluster tracks for it."""

    def __init__(self, host_id: int, cache: SceneCache,
                 executor: "_HostExecutor", mesh=None, devices=None):
        self.id = int(host_id)
        self.cache = cache
        self.executor = executor
        self.mesh = mesh
        self.devices = list(devices) if devices is not None else None
        self.state = "healthy"
        self.hung = False            # stopped beating (heartbeat showcase)
        self.hang_steps = 0          # steps observed hung (clockless kill)
        self.last_beat = 0.0
        self.service_ewma: Optional[float] = None
        self.dispatches = 0
        self.tile_failures = 0       # tiles that entered recovery here
        self.slow_extra_s = 0.0      # persistent (HostEvent "slow")
        self.pending_extra_s = 0.0   # one-shot (FaultPlan host_slow draw)

    def beat(self, now: float) -> None:
        self.last_beat = now

    @property
    def placeable(self) -> bool:
        """Eligible for NEW tile placement (draining/dead are not)."""
        return self.state in ("healthy", "suspect")

    def summary(self) -> dict:
        d = self.dispatches
        cs = self.cache.stats()
        return {
            "state": self.state,
            "dispatches": d,
            "tile_failures": self.tile_failures,
            "goodput_proxy": (round(1.0 - self.tile_failures / d, 4)
                              if d else None),
            "service_ewma_s": (round(self.service_ewma, 6)
                               if self.service_ewma else None),
            "in_flight": self.executor.in_flight,
            "resident_scenes": list(self.cache.resident_scenes),
            "cache_hits": cs["hits"], "cache_misses": cs["misses"],
            "load_failures": cs["load_failures"],
            "n_devices": len(self.devices) if self.devices else None,
        }


class HostPool:
    """The cluster's host container: lookup, liveness views, summary."""

    def __init__(self, hosts: List[Host]):
        self.hosts = list(hosts)
        self._by_id = {h.id: h for h in self.hosts}
        if len(self._by_id) != len(self.hosts):
            raise ValueError("duplicate host ids in pool")

    def __len__(self) -> int:
        return len(self.hosts)

    def __iter__(self):
        return iter(self.hosts)

    def get(self, host_id: int) -> Host:
        return self._by_id[host_id]

    def alive(self) -> List[Host]:
        return [h for h in self.hosts if h.state != "dead"]

    def placeable(self) -> List[Host]:
        return [h for h in self.hosts if h.placeable]

    def summary(self) -> dict:
        return {h.id: h.summary() for h in self.hosts}


# ---------------------------------------------------------------------------
class _HostExecutor(TileExecutor):
    """Per-host executor: the TileExecutor plus host bookkeeping. The
    heartbeat is stamped on every dispatch and drain, the per-host service
    EWMA feeds the shared StragglerMonitor's host table, and injected
    host-slow latency (persistent events and one-shot fault draws) joins
    the in-flight latency the straggler layer sees. ``host`` and the
    ``redispatch_hook`` (cross-host failover) are wired by
    ``ClusterEngine`` once the ``Host`` exists."""

    host: Optional[Host] = None

    def _attempt(self, tile: _Tile, allow_straggle: bool = True):
        handle, cost, extra = super()._attempt(tile, allow_straggle)
        h = self.host
        if h is not None and allow_straggle:
            extra += h.slow_extra_s + h.pending_extra_s
            h.pending_extra_s = 0.0
        return handle, cost, extra

    def _account(self, tile: _Tile, cost: dict) -> None:
        super()._account(tile, cost)
        if self.host is not None:
            self.host.dispatches += 1
            self.host.beat(self._clock())
            m = getattr(self.stats, "m", None)
            if m is not None:
                m.host_dispatches.labels(host=self.host.id).inc()

    def _update_service_ewma(self, dt: float) -> None:
        super()._update_service_ewma(dt)
        h = self.host
        if h is None:
            return
        h.service_ewma = (dt if h.service_ewma is None
                          else 0.7 * h.service_ewma + 0.3 * dt)
        h.beat(self._clock())
        if self.straggler is not None:
            self.straggler.record_host_step(h.id, dt)
        m = getattr(self.stats, "m", None)
        if m is not None:
            m.host_service_seconds.labels(host=h.id).observe(dt)
            m.host_service_ewma.labels(host=h.id).set(h.service_ewma)


# ---------------------------------------------------------------------------
class ClusterScheduler(TileScheduler):
    """The global policy layer over a HostPool. Inherits the single-host
    queue, admission, priority and coalescing machinery and overrides the
    decisions that become cluster-wide:

    * ``_resolve_scene``: scene pick AND host placement in one step; the
      scene goes to the best-scoring placeable host (health rank +
      residency + migrated affinity - load, deterministic hash tie-break),
      and residency comes from THAT host's cache.
    * ``_estimated_queueing_s``: admission against the aggregate backlog
      over the pool's health-weighted service rate.
    * load failures: per-(host, scene) quarantine with probe countdowns
      instead of global scene death; a scene is dead only once every
      placeable host has it quarantined.
    * a re-queue lane for tiles abandoned by a killed host, drained ahead
      of fresh coalescing and re-placed (new host, its resident weights,
      new home cell) without touching request cursors.
    """

    def __init__(self, pool: HostPool, *, quarantine_probe_tiles: int = 8,
                 **kw):
        super().__init__(**kw)
        self.pool = pool
        self.quarantine_probe_tiles = int(quarantine_probe_tiles)
        # (host_id, scene) -> countdown; > 0 blocks placement, == 0
        # means the next placement is a recovery probe
        self._quarantine: Dict[Tuple[int, str], int] = {}
        self._affinity: Dict[str, int] = {}      # scene -> preferred host
        self._requeue: deque = deque()           # tiles from killed hosts
        self._home_cells: Dict[Tuple[str, int], int] = {}  # per host
        self._placed_host: Optional[Host] = None

    # ------------------------------------------------------- placement ----
    def _place(self, scene: str, exclude=()) -> Optional[Host]:
        """Best host for one tile of ``scene``: healthy outranks suspect
        (10 vs 4), + 4 for the scene resident in the host's cache, + 2 for
        migrated affinity, - 0.5 per in-flight tile (load spread), with a
        deterministic per-(scene, host) hash tie-break so equal scores do
        not all pile onto host 0. Quarantined (countdown > 0) and
        non-placeable hosts are skipped; ``None`` means no host can take
        the tile now."""
        best, best_key = None, None
        for h in self.pool.hosts:
            if h.id in exclude or not h.placeable:
                continue
            if self._quarantine.get((h.id, scene), 0) > 0:
                continue
            score = 10.0 if h.state == "healthy" else 4.0
            if scene in h.cache:
                score += 4.0
            if self._affinity.get(scene) == h.id:
                score += 2.0
            score -= 0.5 * h.executor.in_flight
            tie = zlib.crc32(f"{scene}:{h.id}".encode()) / 2.0 ** 32
            key = (score, tie)
            if best_key is None or key > best_key:
                best, best_key = h, key
        return best

    def route_for(self, scene: str, pp, host: Host) -> Optional[int]:
        """Shard-locality routing per host: home cells live on a HOST's
        cell list, so the key is (scene, host) and the same scene routes
        independently on every host's cells."""
        if not self.route_by_shard or getattr(pp, "shard_mesh", None) is None:
            return None
        key = (scene, host.id)
        home = self._home_cells.get(key)
        if home is None:
            from repro_torch.runtime import sharding as rsh
            home = rsh.plcore_home_cell(pp.shard_mesh, pp.cfg.trunk_layers,
                                        salt=scene)
            self._home_cells[key] = home
        return home

    def _route(self, scene_id: str, pp) -> Optional[int]:
        return self.route_for(scene_id, pp, self._placed_host)

    # ------------------------------------------------------- admission ----
    def _estimated_queueing_s(self) -> Optional[float]:
        """Aggregate admission: global backlog (queued tiles + every live
        host's in-flight slots) over the pool's summed service rate, each
        placeable host adding health_weight / ewma (healthy 1.0, suspect
        0.5; the EWMA falls back to ``tile_service_prior_s``). No
        placeable host: infinite predicted delay (every deadlined request
        is refused); hosts but no rate estimate: ``None`` (admit, the
        cold single-host behavior)."""
        hosts = self.pool.placeable()
        if not hosts:
            return float("inf")
        rate = 0.0
        for h in hosts:
            ewma = h.service_ewma or self.tile_service_prior_s
            if ewma:
                rate += (1.0 if h.state == "healthy" else 0.5) / ewma
        if rate <= 0.0:
            return None
        backlog = -(-sum(a.remaining for a in self.queue) // self.tile_rays)
        in_flight = sum(h.executor.in_flight for h in self.pool.alive())
        return (backlog + in_flight) / rate

    # ------------------------------------------------------ quarantine ----
    def _tick_quarantine(self) -> None:
        for k in self._quarantine:
            if self._quarantine[k] > 0:
                self._quarantine[k] -= 1

    def _note_host_load_failure(self, host: Host, scene: str, err) -> None:
        """Account one failed ``cache.get`` on ONE host. A failed recovery
        probe re-arms that host's quarantine window; repeated real
        failures open a new one. Either way the scene is declared dead
        (queued requests terminated, ``partial`` if pixels landed, else
        ``rejected``) only when every placeable host has it
        quarantined."""
        key = ("scene_load_fail_fasts" if err.fail_fast
               else "scene_load_errors")
        self.stats[key] += 1
        qkey = (host.id, scene)
        if qkey in self._quarantine:
            self._quarantine[qkey] = self.quarantine_probe_tiles
            self.stats["quarantine_probes"] += 1
            self.tracer.event("host.quarantine_probe", cat="host",
                              host=host.id, scene=scene)
        elif (not err.fail_fast
              and host.cache.consecutive_failures(scene)
              >= self.max_load_failures):
            self._quarantine[qkey] = self.quarantine_probe_tiles
            self.stats["quarantines"] += 1
            self.tracer.event("host.quarantine", cat="host",
                              host=host.id, scene=scene)
        else:
            return
        self._maybe_declare_dead(scene)

    def _on_scene_loaded(self, host: Host, scene: str) -> None:
        """A successful ``cache.get`` on a host with an open quarantine
        entry is a recovered probe: lift the quarantine."""
        if self._quarantine.pop((host.id, scene), None) is not None:
            self.stats["quarantine_recoveries"] += 1
            self.tracer.event("host.quarantine_recovery", cat="host",
                              host=host.id, scene=scene)

    def _maybe_declare_dead(self, scene: str) -> None:
        hosts = self.pool.placeable()
        if not hosts:
            return      # no alive host: the engine terminates the queue
        if all((h.id, scene) in self._quarantine for h in hosts):
            for a in [a for a in self.queue if a.req.scene_id == scene]:
                self.completion.terminate(
                    a, "partial" if a.n_done > 0 else "rejected",
                    error=f"scene {scene!r} failing on every serving host")

    # ----------------------------------------------------------- policy ----
    def _resolve_scene(self):
        """Scene pick + host placement + residency in one decision. A
        per-call ``(scene, host)`` tried-set guarantees termination: a
        host whose load fails is not retried for that scene this call, and
        a scene with no remaining host is skipped this call (its requests
        stay queued through backoff and probe windows)."""
        scene_tried: set = set()
        host_tried: set = set()
        while True:
            cands = [a for a in self._schedulable()
                     if a.req.scene_id not in scene_tried]
            if not cands:
                return None
            self._mark_degraded(cands)
            scene = self._pick_scene(cands)
            host = self._place(scene, exclude={
                h for (s, h) in host_tried if s == scene})
            if host is None:
                scene_tried.add(scene)
                self._maybe_declare_dead(scene)
                continue
            try:
                pp = host.cache.get(scene)
            except SceneLoadError as e:
                host_tried.add((scene, host.id))
                self._note_host_load_failure(host, scene, e)
                continue
            self._on_scene_loaded(host, scene)
            self._placed_host = host
            return scene, pp, cands, host.id

    # -------------------------------------------------------- re-queue ----
    def requeue(self, tile: _Tile, now: float) -> None:
        tile._requeued_at = now
        self._requeue.append(tile)
        self.stats["requeued_tiles"] += 1
        self.tracer.event("tile.requeue", cat="tile", tile=tile.tid,
                          host=tile.host_id, scene=tile.scene_id)

    def _drop_tile(self, tile: _Tile, reason: str) -> None:
        """Terminal trace record of a tile leaving without a scatter: the
        span-chain validator requires every tile id to end in
        ``tile.scatter`` or ``tile.drop``."""
        self.tracer.event("tile.drop", cat="tile", tile=tile.tid,
                          host=tile.host_id, scene=tile.scene_id,
                          reason=reason)

    def _next_requeued(self) -> Optional[_Tile]:
        """Re-place abandoned tiles ahead of fresh coalescing. Each gets
        one placement look per call (bounded by the lane's length, so the
        call terminates): placed, it is re-resolved against the NEW
        host's cache and returned; load failed or no host free now, it
        goes to the back of the lane; no placeable host at all, its
        non-terminal requests are terminated (their rays can never land)
        so ``drain()`` always makes progress."""
        for _ in range(len(self._requeue)):
            tile = self._requeue.popleft()
            if all(a.terminal for a, _, _ in tile.spans):
                self._drop_tile(tile, "all_requests_terminal")
                continue
            host = self._place(tile.scene_id)
            if host is None:
                if not self.pool.placeable():
                    for a, _, _ in tile.spans:
                        self.completion.terminate(
                            a, "partial" if a.n_done > 0 else "rejected",
                            error=(f"re-queued tile for scene "
                                   f"{tile.scene_id!r} has no serving "
                                   f"host"))
                    self._drop_tile(tile, "no_placeable_host")
                    continue
                self._requeue.append(tile)
                continue
            try:
                pp = host.cache.get(tile.scene_id)
            except SceneLoadError as e:
                self._note_host_load_failure(host, tile.scene_id, e)
                self._requeue.append(tile)
                continue
            self._on_scene_loaded(host, tile.scene_id)
            tile.pp = pp
            tile.host_id = host.id
            tile.home_cell = self.route_for(tile.scene_id, pp, host)
            return tile
        return None

    def next_tile(self) -> Optional[_Tile]:
        self._tick_quarantine()
        tile = self._next_requeued()
        if tile is not None:
            return tile
        return super().next_tile()


# ---------------------------------------------------------------------------
class ClusterEngine(RenderEngine):
    """The multi-host serving fabric behind the single-host facade.

    ``caches`` is one SceneCache per host (each built over its own device
    group: ``split_devices``); ``meshes`` the hosts' cell lists (for the
    summary; the residents carry their own). Everything else matches
    ``RenderEngine``. submit/take/pending/completed/robustness are
    inherited; step/drain go through the pool. ``schedule_host_events``
    arms deterministic kill / slow / drain / rejoin / hang events (serve
    ``--host-kill``, loadgen overload traces); a ``FaultPlan`` with host
    rates adds seeded per-host kill and slow draws at every placement."""

    def __init__(self, caches: List[SceneCache], *,
                 meshes: Optional[list] = None,
                 device_groups: Optional[List[list]] = None,
                 heartbeat_timeout_s: float = 0.5,
                 hang_kill_steps: int = 50,
                 quarantine_probe_tiles: int = 8,
                 tile_rays: int = 512, max_sticky_tiles: int = 64,
                 clock=time.perf_counter, pipeline_depth: int = 1,
                 route_by_shard: bool = False,
                 percell_dispatch: bool = False,
                 max_queue: Optional[int] = None,
                 aging_tiles: Optional[int] = None,
                 degrade_on_overload: bool = False,
                 degrade_queue_tiles: int = 8,
                 degrade_max_priority: int = 0,
                 max_load_failures: int = 3,
                 max_tile_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 faults=None, straggler_mitigation: Optional[bool] = None,
                 straggler_cfg=None, check_finite: bool = True,
                 tile_service_prior_s: Optional[float] = None,
                 tracer=None, registry=None):
        if not caches:
            raise ValueError("ClusterEngine needs at least one host cache")
        # the base constructor builds the stats view, the completion sink
        # and the single-host wiring; its scheduler and executor are
        # replaced below by their cluster versions
        super().__init__(
            caches[0], tile_rays=tile_rays,
            max_sticky_tiles=max_sticky_tiles, clock=clock,
            pipeline_depth=pipeline_depth, route_by_shard=route_by_shard,
            percell_dispatch=percell_dispatch,
            max_queue=max_queue, aging_tiles=aging_tiles,
            degrade_on_overload=degrade_on_overload,
            degrade_queue_tiles=degrade_queue_tiles,
            degrade_max_priority=degrade_max_priority,
            max_load_failures=max_load_failures,
            max_tile_retries=max_tile_retries,
            retry_backoff_s=retry_backoff_s, faults=faults,
            straggler_mitigation=straggler_mitigation,
            straggler_cfg=straggler_cfg, check_finite=check_finite,
            tile_service_prior_s=tile_service_prior_s,
            tracer=tracer, registry=registry)
        extend_stats_view(self.stats, CLUSTER_STATS_SCHEMA)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.hang_kill_steps = int(hang_kill_steps)
        self.monitor = self.executor.straggler   # shared across hosts
        self._t0 = clock()
        self._events: List[HostEvent] = []
        self._fired: set = set()

        groups = device_groups or [None] * len(caches)
        mesh_list = meshes or [None] * len(caches)
        hosts = []
        for i, cache in enumerate(caches):
            cache.tracer = self.tracer
            cache.trace_host = i
            ex = _HostExecutor(
                self.completion, cache, self.stats, depth=pipeline_depth,
                faults=faults, straggler=self.monitor,
                max_tile_retries=max_tile_retries,
                retry_backoff_s=retry_backoff_s,
                check_finite=check_finite, clock=clock,
                tracer=self.tracer, percell=percell_dispatch)
            host = Host(i, cache, ex, mesh=mesh_list[i], devices=groups[i])
            ex.host = host
            ex.redispatch_hook = (lambda tile, h=host:
                                  self._failover(h, tile))
            host.beat(self._t0)
            hosts.append(host)
        self.pool = HostPool(hosts)
        self.scheduler = ClusterScheduler(
            self.pool, quarantine_probe_tiles=quarantine_probe_tiles,
            cache=caches[0], tile_rays=tile_rays,
            max_sticky_tiles=max_sticky_tiles,
            route_by_shard=route_by_shard, stats=self.stats, clock=clock,
            max_queue=max_queue, aging_tiles=aging_tiles,
            degrade_on_overload=degrade_on_overload,
            degrade_queue_tiles=degrade_queue_tiles,
            degrade_max_priority=degrade_max_priority,
            max_load_failures=max_load_failures,
            tile_service_prior_s=tile_service_prior_s,
            tracer=self.tracer)
        self.scheduler.completion = self.completion
        self.scheduler.executor = hosts[0].executor
        self.completion.scheduler = self.scheduler
        # the facade's introspection (pipeline_depth, percell_report) reads
        # ONE executor: host 0 stands in
        self.executor = hosts[0].executor
        for h in hosts:
            self._note_host_state(h)

    # ----------------------------------------------------- host events ----
    def _note_host_state(self, host: Host) -> None:
        """Mirror one host's lifecycle state into the labeled gauge (the
        value is the index into HOST_STATES)."""
        m = getattr(self.stats, "m", None)
        if m is not None:
            m.host_state.labels(host=host.id).set(
                HOST_STATES.index(host.state))

    def schedule_host_events(self, events: List[HostEvent]) -> None:
        self._events.extend(events)

    def _apply_due_events(self, now: float) -> None:
        for i, ev in enumerate(self._events):
            if i in self._fired:
                continue
            due = ((ev.at_dispatch is not None
                    and self.stats["dispatches"] >= ev.at_dispatch)
                   or (ev.at_s is not None and now - self._t0 >= ev.at_s)
                   or (ev.at_s is None and ev.at_dispatch is None))
            if not due:
                continue
            self._fired.add(i)
            host = self.pool.get(ev.host)
            if ev.kind == "kill":
                self._kill_host(host)
            elif ev.kind == "slow":
                host.slow_extra_s = ev.extra_s
                self.stats["host_slow_events"] += 1
                self.tracer.event("host.slow", cat="host", host=host.id,
                                  extra_s=ev.extra_s)
            elif ev.kind == "drain":
                self._drain_host(host)
            elif ev.kind == "rejoin":
                self._rejoin_host(host, now)
            elif ev.kind == "hang":
                host.hung = True
                host.hang_steps = 0
                self.tracer.event("host.hang", cat="host", host=host.id)

    def _kill_host(self, host: Host) -> None:
        """A host dies NOW: abandon its in-flight slots (never
        materialized), re-queue the tiles for placement on other hosts,
        drop its affinity. Requests keep their cursors; the re-queued
        tiles carry their pixels' only path home, which is why the
        re-queue lane is drained first."""
        if host.state == "dead":
            return
        host.state = "dead"
        host.hung = False
        now = self._clock()
        abandoned = host.executor.abandon_all()
        for tile in abandoned:
            self.scheduler.requeue(tile, now)
        self.stats["host_kills"] += 1
        self.tracer.event("host.kill", cat="host", host=host.id,
                          requeued=len(abandoned))
        self._note_host_state(host)
        aff = self.scheduler._affinity
        for scene in [s for s, hid in aff.items() if hid == host.id]:
            del aff[scene]

    def _drain_host(self, host: Host) -> None:
        """Graceful exit: no new placements, in-flight tiles finish
        normally, and cached-scene affinity migrates: each resident scene
        gets a placement bonus on a live host and its (unpinned) weights
        are discarded here."""
        if host.state in ("dead", "draining"):
            return
        host.state = "draining"
        self.stats["host_drains"] += 1
        self.tracer.event("host.drain", cat="host", host=host.id)
        self._note_host_state(host)
        for scene in list(host.cache.resident_scenes):
            alt = self.scheduler._place(scene, exclude={host.id})
            if alt is not None:
                self.scheduler._affinity[scene] = alt.id
                self.stats["affinity_migrations"] += 1
            host.cache.discard(scene)

    def _rejoin_host(self, host: Host, now: float) -> None:
        if host.state in ("dead", "draining"):
            host.state = "healthy"
            host.hung = False
            host.hang_steps = 0
            host.beat(now)
            self.stats["host_rejoins"] += 1
            self.tracer.event("host.rejoin", cat="host", host=host.id)
            self._note_host_state(host)

    # ----------------------------------------------------------- health ----
    def _health_check(self, now: float) -> None:
        """Heartbeat + slowness pass. A hung host (stopped beating with
        tiles in flight) is detected by beat staleness, or under fake
        clocks by ``hang_kill_steps`` observed-hung steps, and killed,
        which re-queues its tiles. A stale beat without a hang marks the
        host suspect past ``heartbeat_timeout_s`` and kills it past twice
        that. Slow hosts (monitor EWMA above ``slow_factor`` x the median)
        are flagged ``suspect``: deprioritized for placement and
        half-weighted in admission, not killed."""
        slow = set(self.monitor.slow_hosts()) if self.monitor else set()
        for h in self.pool.hosts:
            if h.state in ("dead", "draining"):
                continue
            stale = (h.executor.in_flight > 0
                     and now - h.last_beat > self.heartbeat_timeout_s)
            if h.hung:
                h.hang_steps += 1
                if stale or h.hang_steps > self.hang_kill_steps:
                    self.stats["heartbeat_timeouts"] += 1
                    self.tracer.event("host.heartbeat_timeout", cat="host",
                                      host=h.id, hung=True)
                    self._kill_host(h)
                continue
            if stale:
                if now - h.last_beat > 2.0 * self.heartbeat_timeout_s:
                    self.stats["heartbeat_timeouts"] += 1
                    self.tracer.event("host.heartbeat_timeout", cat="host",
                                      host=h.id, hung=False)
                    self._kill_host(h)
                elif h.state == "healthy":
                    h.state = "suspect"
                    self.tracer.event("host.suspect", cat="host", host=h.id,
                                      reason="stale_heartbeat")
                    self._note_host_state(h)
                continue
            if h.id in slow:
                if h.state == "healthy":
                    h.state = "suspect"
                    self.stats["slow_host_flags"] += 1
                    self.tracer.event("host.suspect", cat="host", host=h.id,
                                      reason="slow")
                    self._note_host_state(h)
            elif h.state == "suspect":
                h.state = "healthy"
                self._note_host_state(h)

    # --------------------------------------------------------- failover ----
    def _failover(self, failed_host: Host, tile: _Tile):
        """Executor hook: a tile failed on ``failed_host``; try ONE
        synchronous dispatch on the best OTHER host (the same scene
        weights and per-ray independence: the same bits). The wait is on
        that dispatch's own handle. Any failure (no host, a load error, an
        injected or real dispatch error, a corrupt result) returns
        ``None``, and the caller's local retry -> oracle ladder runs as
        the last rung."""
        failed_host.tile_failures += 1
        sched = self.scheduler
        host = sched._place(tile.scene_id, exclude={failed_host.id})
        if host is None:
            return None
        try:
            pp = host.cache.get(tile.scene_id)
        except SceneLoadError as e:
            sched._note_host_load_failure(host, tile.scene_id, e)
            return None
        sched._on_scene_loaded(host, tile.scene_id)
        if self.faults is not None:
            fault = self.faults.draw_dispatch(allow_straggle=False)
            if fault is not None and fault["kind"] == "dispatch_error":
                host.tile_failures += 1
                return None
        home = sched.route_for(tile.scene_id, pp, host)
        kw = {} if home is None else {"home_cell": home}
        try:
            handle, cost = pp.dispatch_tile(
                *tile.rays, coarse_only=tile.degraded, **kw)
            arr = handle.result()
        except Exception:
            # the reference's semantics: any failure here declines, and
            # the local ladder counts and resolves the tile
            host.tile_failures += 1
            return None
        host.executor._device_span(tile, handle)
        if self.faults is not None:
            bad = self.faults.corrupt_tile(arr)
            if bad is not None:
                arr = bad
        if not np.isfinite(arr[:tile.n_real]).all():
            host.tile_failures += 1
            return None
        host.dispatches += 1
        host.beat(self._clock())
        self.stats["cross_host_redispatches"] += 1
        self.tracer.event("tile.redispatch", cat="tile", tile=tile.tid,
                          scene=tile.scene_id, from_host=failed_host.id,
                          host=host.id)
        tile.prev_host = host.id
        return arr, cost

    # ------------------------------------------------------------- loop ----
    def _dispatch_on(self, host: Host, tile: _Tile, now: float) -> None:
        if tile.prev_host is not None and tile.prev_host != host.id:
            self.stats["cross_host_redispatches"] += 1
        t0 = getattr(tile, "_requeued_at", None)
        if t0 is not None:
            self.stats["failovers"] += 1
            self.stats["failover_latency_s"] += max(0.0, now - t0)
            tile._requeued_at = None
        tile.prev_host = host.id
        host.executor.dispatch(tile)

    def step(self) -> bool:
        """One cluster iteration: apply due host events, run the health
        pass, expire overdue requests, then place + dispatch one tile
        (host kill and slow draws happen at placement: a killed host's
        tile goes straight to the re-queue lane) or drain the fullest
        drainable host. With every host dead, queued requests are
        terminated (their rays can never land) so drain() still
        converges. Returns False only when fully idle."""
        now = self._clock()
        self._apply_due_events(now)
        self._health_check(now)
        self.scheduler.expire(now)
        if not self.pool.alive():
            progressed = False
            for a in list(self.scheduler.queue):
                self.completion.terminate(
                    a, "partial" if a.n_done > 0 else "rejected",
                    error="no alive hosts in the serving pool")
                progressed = True
            while self.scheduler._requeue:
                self.scheduler._drop_tile(self.scheduler._requeue.popleft(),
                                          "no_alive_hosts")
            return progressed
        tile = self.scheduler.next_tile()
        if tile is not None:
            host = self.pool.get(tile.host_id)
            if self.faults is not None:
                ev = self.faults.draw_host_event(host.id)
                if ev is not None:
                    if ev["kind"] == "host_kill":
                        self._kill_host(host)
                        self.scheduler.requeue(tile, now)
                        return True
                    host.pending_extra_s += ev["extra_s"]
                    self.stats["host_slow_events"] += 1
            self._dispatch_on(host, tile, now)
            return True
        drainable = [h for h in self.pool.alive()
                     if h.executor.in_flight and not h.hung]
        if drainable:
            fullest = max(drainable,
                          key=lambda h: (h.executor.in_flight, -h.id))
            fullest.executor.drain_one()
            return True
        if any(h.hung and h.executor.in_flight for h in self.pool.hosts):
            return True     # waiting on the heartbeat timeout to kill it
        return False

    @property
    def in_flight_tiles(self) -> int:
        return sum(h.executor.in_flight for h in self.pool.hosts)

    def drain(self, max_steps: Optional[int] = None) -> int:
        steps = 0
        while ((self.scheduler.queue or self.in_flight_tiles
                or self.scheduler._requeue)
               and (max_steps is None or steps < max_steps)):
            self.step()
            steps += 1
        return steps

    # ------------------------------------------------------- reporting ----
    def cluster_stats(self) -> dict:
        st = self.stats
        nf = st["failovers"]
        return {
            "n_hosts": len(self.pool),
            "hosts": self.pool.summary(),
            "cross_host_redispatches": st["cross_host_redispatches"],
            "host_kills": st["host_kills"],
            "host_slow_events": st["host_slow_events"],
            "requeued_tiles": st["requeued_tiles"],
            "quarantines": st["quarantines"],
            "quarantine_probes": st["quarantine_probes"],
            "quarantine_recoveries": st["quarantine_recoveries"],
            "affinity_migrations": st["affinity_migrations"],
            "heartbeat_timeouts": st["heartbeat_timeouts"],
            "slow_host_flags": st["slow_host_flags"],
            "host_drains": st["host_drains"],
            "host_rejoins": st["host_rejoins"],
            "failovers": nf,
            "failover_latency_s": round(st["failover_latency_s"], 6),
            "mean_failover_latency_s": (
                round(st["failover_latency_s"] / nf, 6) if nf else None),
        }

    def robustness(self) -> dict:
        out = super().robustness()
        out["cluster"] = self.cluster_stats()
        return out

    def percell_report(self) -> Optional[dict]:
        """``RenderEngine.percell_report`` over every host: the cells of
        all hosts' executors, keyed ``"host:cell"`` (each host's cells are
        its own group)."""
        out = super().percell_report()
        if out is not None:
            out["cells"] = {
                f"{h.id}:{c}": dict(v) for h in self.pool.hosts
                for c, v in sorted(h.executor.cell_stats.items(),
                                   key=lambda kv: (kv[0] is None, kv[0]))}
        return out
