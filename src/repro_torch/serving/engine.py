"""Multi-tenant render engine: scheduler / executor / completion layers.

ICARUS scales by putting a ray dispatcher in front of many PLCores; once
the per-sample kernel is fused, the remaining throughput levers are
scheduling and memory traffic. The engine is that dispatcher, in three
layers:

* ``TileScheduler`` — the policy layer. Owns the request queue
  (``submit`` allocates a NaN-filled framebuffer: every pixel must arrive
  via a tile scatter, so gaps or cross-request leaks surface as NaN),
  picks the next scene by (priority, FIFO) with sticky-scene grouping, and
  coalesces one fixed-shape tile of ``tile_rays`` rays across that scene's
  pending requests, padding only the tail.
* ``TileExecutor`` — the dispatch layer. Keeps up to ``pipeline_depth``
  tiles in flight: ``PackedPlcore.dispatch_tile`` returns a handle whose
  drain waits on that tile's own CUDA event, so the executor dispatches
  tile k+1 and drains tile k-(depth-1) while the card computes the tiles
  in between. ``pipeline_depth=1`` drains every dispatch at once: the
  synchronous dispatch -> wait -> scatter loop. The executor pins each
  tile's scene in the ``SceneCache`` for the life of the slot.
* ``CompletionSink`` — the output layer. Scatters a drained tile's pixels
  to each contributing request's framebuffer and completes requests OUT
  OF ORDER as their last ray lands.

``RenderEngine`` wires the three behind ``submit``/``step``/``drain``/
``take``. Every per-ray operation depends only on its own ray, so the
images are the same at any pipeline depth and tile partition.

Fault tolerance
---------------

A loader exception, a NaN-poisoned tile or a straggling dispatch does not
crash or corrupt the other requests: ``step()`` and ``drain()`` do not
raise for those fault classes. Every submitted request reaches exactly ONE
terminal status:

* ``ok``       — every pixel delivered at full quality.
* ``degraded`` — completed coarse-only under the overload-degradation
  policy, flagged.
* ``partial``  — deadline expired mid-render; delivered with the pixels
  that landed (the rest stay NaN).
* ``expired``  — deadline expired before the first ray was tiled.
* ``rejected`` — refused: at admission (bounded queue full, or the
  predicted queueing delay alone exceeds the deadline) or because its
  scene's loader failed ``max_load_failures`` consecutive times.

Recovery ladder for a failed tile (the dispatch raised, or the drained
buffer is non-finite): up to ``max_tile_retries`` fresh dispatches with
capped exponential backoff (a retry renders the same rays through the same
resident weights, so its pixels are the same bits), then the two-dispatch
oracle program (``PackedPlcore.render_tile_oracle``: K1 twice with the
resample on the host, for a fused instance). On the card the oracle agrees
with K2 to the K1-vs-K2 tolerance, not bit for bit. A ``StragglerMonitor``
watches per-tile in-flight latency; a tile past the deadline factor is
abandoned and redispatched. ``serving.faults.FaultPlan`` injects each
fault class deterministically.

Adaptive sampling (ASDR)
------------------------

With ``adaptive_sampling`` the engine renders through one
``core.pipeline.AdaptiveRenderer`` per scene (``AdaptiveSampling``): the
scene's first touch runs the density probe (``build_scene_aux``), whose
stats and trunk memo ride the scene's cache entry. The scheduler buckets
each request's rays by fine-sample budget class, with one more bucket for
hinted-dead rays, and coalesces budget-pure tiles (shrunk to a power of two
down to 32 rays when a bucket runs low); the executor renders each at its
class's ``n_fine`` with the memo-dead rows masked out of K2, and a tile of
dead rays only never reaches the kernel.

Shard routing and per-cell dispatch
-----------------------------------

With residents whose trunk stacks are layer-sharded over a cell list
(``runtime.sharding``), ``route_by_shard`` gives every scene a home cell
from the owner map (the most layers owned, ties spread by scene id), so
the modeled weight-gather traffic of each dispatch
(``plcore_gather_count``/``_bytes``) counts only the layers its home cell
does not own. ``percell_dispatch`` runs each routed tile ON its home cell:
the scene's weights are staged there once per (scene, cell), the tile's
K2 launch goes to the cell's own CUDA stream, and the in-flight budget is
``pipeline_depth`` per cell (``percell_report``). Pixels equal the
replicated engine's bit for bit either way.

Tracing
-------

With a ``SpanTracer`` the engine records the request and tile lifecycle
(``request.*``, ``tile.*``, ``cache.*``), the reference's span chain:
``tile.device_compute`` is a slot's life, dispatch to drain, on the
host's clock. On the card each drained tile also gets ``tile.kernel``
(category ``device``): its interval on the device, from the CUDA events
around its render, placed on the tracer's clock by one anchor event
recorded on the idle device before the engine's first tile. The union of
these spans over the traced window is the card's busy share
(``obs.export.device_busy``); a CPU trace has none.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data import rays as R
from repro_torch.obs.metrics import (PERCELL_STATS_SCHEMA,
                                     ROUTING_STATS_SCHEMA,
                                     SAMPLING_STATS_SCHEMA, MetricsRegistry,
                                     engine_stats_view, extend_stats_view)
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.faults import FaultPlan, InjectedDispatchError
from repro_torch.serving.scene_cache import SceneCache, SceneLoadError

#: Terminal request statuses (see module docstring).
STATUSES = ("ok", "degraded", "partial", "expired", "rejected")


@dataclass(frozen=True)
class RenderRequest:
    """One render-an-image request. The camera is a spherical orbit pose;
    ``priority`` is higher-wins, ties FIFO. ``deadline_s`` (relative to
    submit) arms SLO admission control and expiry; ``None`` never
    expires."""
    scene_id: str
    hw: int = 64
    theta: float = 45.0
    phi: float = -25.0
    radius: float = 4.0
    priority: int = 0
    deadline_s: Optional[float] = None


@dataclass
class RenderResult:
    request_id: int
    scene_id: str
    image: np.ndarray            # (hw, hw, 3) float32
    n_rays: int
    submit_s: float              # engine-clock timestamps
    service_start_s: float       # first ray handed to a tile
    complete_s: float
    dispatch_baseline: int       # tiles a request-at-a-time server pays
    status: str = "ok"           # terminal status (STATUSES)
    error: Optional[str] = None  # human-readable failure reason
    retries: int = 0             # tile retry attempts touching this request
    fallbacks: int = 0           # oracle-fallback tiles touching it

    @property
    def latency_s(self) -> float:
        return self.complete_s - self.submit_s

    @property
    def queueing_s(self) -> float:
        """Time in the queue before the first ray was handed to a tile."""
        return self.service_start_s - self.submit_s

    @property
    def service_s(self) -> float:
        """First-ray-dispatched -> last-pixel-scattered."""
        return self.complete_s - self.service_start_s

    @property
    def delivered(self) -> bool:
        """Whether the image carries fully rendered pixels (``ok`` /
        ``degraded``): the goodput numerator."""
        return self.status in ("ok", "degraded")


class _Active:
    """Queue entry: request + flattened rays + framebuffer + cursors.
    Under adaptive sampling the ``next_ray`` cursor is joined by
    per-bucket ray index lists (``bucket_idx``/``bucket_next``): rays are
    handed out bucket by bucket so tiles stay (scene, budget)-pure, while
    ``next_ray`` counts every ray handed out, so ``remaining`` and the
    admission arithmetic do not see the buckets."""
    __slots__ = ("req", "rid", "seq", "rays_o", "rays_d", "fb",
                 "next_ray", "n_done", "n_rays", "submit_s",
                 "service_start_s", "deadline_abs", "terminal",
                 "degraded", "retries", "fallbacks",
                 "dispatches_at_submit", "trace_span",
                 "bucket_idx", "bucket_next")

    def __init__(self, req: RenderRequest, rid: int, seq: int, now: float):
        self.req, self.rid, self.seq, self.submit_s = req, rid, seq, now
        c2w = R.pose_spherical(req.theta, req.phi, req.radius)
        ro, rd = R.camera_rays(c2w, req.hw, req.hw, 0.9 * req.hw)
        self.rays_o = ro.numpy().astype(np.float32).reshape(-1, 3)
        self.rays_d = rd.numpy().astype(np.float32).reshape(-1, 3)
        self.n_rays = self.rays_o.shape[0]
        # NaN framebuffer: a pixel the scatter never wrote, or a padded
        # tail ray leaking into a neighbor, cannot hide as black
        self.fb = np.full((self.n_rays, 3), np.nan, np.float32)
        self.next_ray = 0            # rays handed to tiles so far
        self.n_done = 0              # rays scattered back so far
        self.service_start_s = None  # set when the first ray is tiled
        self.deadline_abs = (None if req.deadline_s is None
                             else now + req.deadline_s)
        self.terminal = False        # a terminal RenderResult exists
        self.degraded = False        # overload policy: coarse-only tiles
        self.retries = 0
        self.fallbacks = 0
        self.dispatches_at_submit = 0   # priority-aging anchor
        self.trace_span = None          # open request-lifecycle span
        self.bucket_idx = None          # per-bucket ray index lists
        self.bucket_next = None         # per-bucket hand-out cursors

    @property
    def remaining(self) -> int:
        return self.n_rays - self.next_ray


@dataclass
class _Tile:
    """One coalesced dispatch unit flowing scheduler -> executor ->
    completion. ``spans`` records which request contributed which rays
    (``(_Active, start, take)``: ``start`` an int for a contiguous span,
    an index array for an adaptive bucket's rays), so completion can
    scatter out of order."""
    scene_id: str
    pp: object                  # resident PackedPlcore
    spans: List[tuple]
    rays_o: np.ndarray
    rays_d: np.ndarray
    n_real: int                 # non-pad rays
    home_cell: Optional[int] = None   # shard-locality routing
    degraded: bool = False      # coarse-only program
    budget: Optional[int] = None   # adaptive fine-sample budget
    dead_bucket: bool = False   # rays all hinted dead: resolve the memo
    tid: int = -1               # deterministic trace id


# ---------------------------------------------------------------------------
class AdaptiveSampling:
    """The ASDR coordinator that scheduler and executor share: one
    ``core.pipeline.AdaptiveRenderer`` per scene, riding the SceneCache.

    A scene's first touch runs the density probe (``build_scene_aux``)
    through ``SceneCache.ensure_aux``: the stats and the trunk memo become
    auxiliary residents of the scene's cache entry, counted and evicted
    with it. A renderer is rebuilt whenever the resident ``PackedPlcore``
    changed (an eviction and reload dropped the old aux with the old
    weights), so stale stats never classify rays for fresh weights."""

    def __init__(self, cache: SceneCache, *, budgets=None,
                 memo_mb: float = 32.0, grid_res: int = 32,
                 probe_hw: int = 8):
        self.cache = cache
        self.budgets = tuple(int(b) for b in budgets) if budgets else None
        self.memo_mb = float(memo_mb)
        self.grid_res = int(grid_res)
        self.probe_hw = int(probe_hw)
        self._renderers: Dict[str, object] = {}
        self.probe_s = 0.0          # host time of the density probes

    def renderer(self, scene_id: str, pp):
        """The scene's AdaptiveRenderer; probes and builds on first touch
        (the scene is resident: the scheduler's ``cache.get`` ran) and
        after a reload."""
        ar = self._renderers.get(scene_id)
        if ar is not None and ar.pp is pp:
            return ar
        from repro_torch.core import pipeline as P
        n_classes = len(self.budgets) if self.budgets else 3
        t0 = time.perf_counter()
        aux = self.cache.ensure_aux(
            scene_id,
            lambda p: P.build_scene_aux(
                p, grid_res=self.grid_res, n_classes=n_classes,
                memo_mb=self.memo_mb, probe_hw=self.probe_hw))
        self.probe_s += time.perf_counter() - t0
        ar = P.AdaptiveRenderer(pp, aux, self.budgets)
        self._renderers[scene_id] = ar
        return ar

    def account(self, tile: "_Tile", info: dict, stats: dict) -> None:
        """Fold one adaptive dispatch's info into the engine stats (the
        ``SAMPLING_STATS_SCHEMA`` keys) and the per-budget families."""
        stats["adaptive_tiles"] += 1
        stats["dead_rays"] += info["dead"]
        stats["skipped_fine_samples"] += info["skipped_fine_samples"]
        if info["full_dead"]:
            stats["full_dead_tiles"] += 1
        hits = misses = evs = topup = rays = dead = 0
        resident = 0.0
        for ar in self._renderers.values():
            ms = ar.aux.memo.stats()
            hits += ms["hits"]
            misses += ms["misses"]
            evs += ms["evictions"]
            resident += ms["resident_mb"]
            topup += ar.counters["topup_voxels"]
            rays += ar.counters["rays"]
            dead += ar.counters["dead_rays"]
        stats["memo_hits"] = hits
        stats["memo_misses"] = misses
        stats["memo_evictions"] = evs
        stats["memo_topup_voxels"] = topup
        stats["memo_resident_mb"] = round(resident, 3)
        stats["dead_ray_fraction"] = round(dead / rays, 4) if rays else 0.0
        m = getattr(stats, "m", None)
        if m is not None:
            m.budget_tiles.labels(budget_class=info["budget"]).inc()
            m.budget_rays.labels(budget_class=info["budget"]).inc(
                info["rays"])

    def report(self) -> dict:
        """Per-scene ``sampling`` blocks (budget histograms, memo traffic,
        host ms per tile) keyed by scene id."""
        return {sid: ar.report()
                for sid, ar in sorted(self._renderers.items())}


# ---------------------------------------------------------------------------
class TileScheduler:
    """Layer 1 — policy. Queue, admission control, priority/sticky-scene
    pick (with optional deterministic priority aging), overload
    degradation, deadline expiry, tile coalescing and shard-locality
    routing. Produces ``_Tile``s and never touches the device. A scene
    whose ``SceneCache.get`` raises is skipped for the current tile, and
    its queued requests are terminated once the cache reports
    ``max_load_failures`` consecutive real failures."""

    def __init__(self, cache: SceneCache, *, tile_rays: int,
                 max_sticky_tiles: int, stats: dict, clock,
                 route_by_shard: bool = False,
                 max_queue: Optional[int] = None,
                 aging_tiles: Optional[int] = None,
                 degrade_on_overload: bool = False,
                 degrade_queue_tiles: int = 8,
                 degrade_max_priority: int = 0,
                 max_load_failures: int = 3,
                 tile_service_prior_s: Optional[float] = None,
                 adaptive: Optional[AdaptiveSampling] = None,
                 tracer=None):
        self.cache = cache
        # adaptive sampling: rays classify into fine-sample budget classes
        # and tiles coalesce (scene, budget)-pure
        self.adaptive = adaptive
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.tile_rays = int(tile_rays)
        # after this many consecutive tiles for one scene the best-ranked
        # request wins even at equal priority: residency amortizes, but
        # an early request for another scene is not starved forever
        self.max_sticky_tiles = int(max_sticky_tiles)
        self.route_by_shard = bool(route_by_shard)
        self.stats = stats
        self._clock = clock
        self.max_queue = max_queue
        self.aging_tiles = aging_tiles
        self.degrade_on_overload = bool(degrade_on_overload)
        self.degrade_queue_tiles = int(degrade_queue_tiles)
        self.degrade_max_priority = int(degrade_max_priority)
        self.max_load_failures = int(max_load_failures)
        self.tile_service_prior_s = tile_service_prior_s
        self.queue: List[_Active] = []
        self._seq = 0
        self._tile_seq = 0           # deterministic per-engine tile ids
        self._current_scene: Optional[str] = None
        self._sticky_run = 0         # consecutive tiles for current scene
        self._home_cells: Dict[str, int] = {}   # scene -> routed cell
        self._deadlines_armed = False
        self.completion: Optional["CompletionSink"] = None   # wired by engine
        self.executor: Optional["TileExecutor"] = None       # wired by engine

    # ------------------------------------------------------- admission ----
    def _estimated_queueing_s(self) -> Optional[float]:
        """Predicted wait until a NEW request's first ray is tiled: the
        backlog ahead of it (queued tiles + in-flight slots) times the
        observed per-tile service EWMA, or ``tile_service_prior_s`` before
        any tile has drained; ``None`` (admit) with neither."""
        ewma = (self.stats.get("tile_service_s_ewma")
                or self.tile_service_prior_s)
        if not ewma:
            return None
        backlog = -(-sum(a.remaining for a in self.queue) // self.tile_rays)
        in_flight = self.executor.in_flight if self.executor else 0
        return (backlog + in_flight) * ewma

    def submit(self, req: RenderRequest) -> int:
        """Enqueue a request; returns its request id. A request refused by
        admission control still gets an id: its terminal ``rejected``
        result is recorded at once, so every submit is answered once."""
        if req.hw < 1:
            raise ValueError(f"request resolution must be >= 1, got "
                             f"hw={req.hw}")
        rid = self._seq
        self._seq += 1
        a = _Active(req, rid, rid, self._clock())
        a.dispatches_at_submit = self.stats["dispatches"]
        tr = self.tracer
        if tr.enabled and tr.sampled_request(rid):
            a.trace_span = tr.begin("request", cat="request", request=rid,
                                    scene=req.scene_id, hw=req.hw,
                                    priority=req.priority)
            tr.event("request.submit", cat="request", request=rid,
                     scene=req.scene_id)
        if req.deadline_s is not None:
            self._deadlines_armed = True
        reason = None
        if (self.max_queue is not None
                and len(self.queue) >= self.max_queue):
            reason = (f"queue full ({len(self.queue)} >= "
                      f"max_queue={self.max_queue})")
        elif req.deadline_s is not None:
            est = self._estimated_queueing_s()
            if est is not None and est > req.deadline_s:
                reason = (f"admission control: predicted queueing delay "
                          f"{est:.4f}s exceeds deadline {req.deadline_s}s")
        if reason is not None:
            if a.trace_span is not None:
                tr.event("request.reject", cat="request", request=rid,
                         reason=reason)
            self.completion.terminate(a, "rejected", error=reason)
            return rid
        if a.trace_span is not None:
            tr.event("request.admit", cat="request", request=rid,
                     queue_depth=len(self.queue))
        self.queue.append(a)
        m = getattr(self.stats, "m", None)
        if m is not None:
            m.queue_depth.set(len(self.queue))
            m.queue_depth_hist.observe(len(self.queue))
        self.stats["dispatch_baseline"] += -(-a.n_rays // self.tile_rays)
        return rid

    def remove(self, a: _Active) -> None:
        self.queue.remove(a)

    def expire(self, now: float) -> None:
        """Terminate overdue requests: ``partial`` if any pixels landed,
        ``expired`` otherwise. In-flight tiles of a terminated request
        scatter harmlessly into the void (``late_rays``)."""
        if not self._deadlines_armed:
            return
        for a in [a for a in self.queue
                  if a.deadline_abs is not None and now >= a.deadline_abs]:
            self.completion.terminate(
                a, "partial" if a.n_done > 0 else "expired",
                error=f"deadline {a.req.deadline_s}s exceeded")

    # ----------------------------------------------------------- policy ----
    def _eff_priority(self, a: _Active) -> int:
        """Priority with deterministic aging: every ``aging_tiles`` engine
        dispatches a request has waited, its effective priority rises by
        one. Counted in dispatches, not seconds, so closed-loop decisions
        stay clockless."""
        if not self.aging_tiles:
            return a.req.priority
        waited = self.stats["dispatches"] - a.dispatches_at_submit
        return a.req.priority + waited // self.aging_tiles

    def _rank(self, a: _Active):
        return (-self._eff_priority(a), a.seq)

    def _schedulable(self) -> List[_Active]:
        """Requests with rays left to hand out. Requests whose rays are
        all in flight stay queued but do not influence the scene choice,
        so any pipeline depth walks the same policy path."""
        return [a for a in self.queue if a.remaining > 0]

    def _pick_scene(self, cands: List[_Active]) -> str:
        """Scene of the best-ranked schedulable request, but sticky to
        the current scene while it has queued rays at the same top
        priority; a strictly higher priority preempts, and
        ``max_sticky_tiles`` bounds the stickiness."""
        best = min(cands, key=self._rank)
        if (self._current_scene is not None
                and self._sticky_run < self.max_sticky_tiles):
            mine = [self._eff_priority(a) for a in cands
                    if a.req.scene_id == self._current_scene]
            if mine and self._eff_priority(best) <= max(mine):
                return self._current_scene
        return best.req.scene_id

    def _mark_degraded(self, cands: List[_Active]) -> None:
        """Overload degradation: when the queued backlog exceeds
        ``degrade_queue_tiles`` tiles, requests at or below
        ``degrade_max_priority`` that have NOT started rendering switch
        to the coarse-only program for their whole image, flagged in the
        stats and in the terminal status (``degraded``)."""
        if not self.degrade_on_overload:
            return
        backlog = -(-sum(a.remaining for a in cands) // self.tile_rays)
        if backlog <= self.degrade_queue_tiles:
            return
        for a in cands:
            if (not a.degraded and a.service_start_s is None
                    and self._eff_priority(a) <= self.degrade_max_priority):
                a.degraded = True
                self.stats["degraded_requests"] += 1

    def _route(self, scene_id: str, pp) -> Optional[int]:
        """Shard-locality routing: the tile's home cell is a cell owning
        the most of this scene's trunk layers (the owner map), scenes
        spread over tied cells by their ids; every layer it owns is a
        remote fetch the scene's dispatches do not pay. ``None``
        (unrouted) when routing is off or the resident is not sharded."""
        if not self.route_by_shard or getattr(pp, "shard_mesh", None) is None:
            return None
        home = self._home_cells.get(scene_id)
        if home is None:
            from repro_torch.runtime import sharding as rsh
            home = rsh.plcore_home_cell(pp.shard_mesh, pp.cfg.trunk_layers,
                                        salt=scene_id)
            self._home_cells[scene_id] = home
        return home

    def _note_load_failure(self, scene: str, err: SceneLoadError) -> None:
        """Account one failed ``cache.get``; once the cache reports
        ``max_load_failures`` consecutive real failures, terminate every
        queued request for the scene (``partial`` if pixels landed, else
        ``rejected``), so the loop always makes progress."""
        key = "scene_load_fail_fasts" if err.fail_fast else "scene_load_errors"
        self.stats[key] += 1
        if (not err.fail_fast
                and self.cache.consecutive_failures(scene)
                >= self.max_load_failures):
            for a in [a for a in self.queue if a.req.scene_id == scene]:
                self.completion.terminate(
                    a, "partial" if a.n_done > 0 else "rejected",
                    error=f"scene load failed: {err}")

    def _resolve_scene(self):
        """The best loadable scene and its resident weights:
        ``(scene_id, pp, cands)``, or ``None`` when no request has rays
        left (or every candidate scene's loader is failing)."""
        tried = set()
        while True:
            cands = [a for a in self._schedulable()
                     if a.req.scene_id not in tried]
            if not cands:
                return None
            self._mark_degraded(cands)
            scene = self._pick_scene(cands)
            try:
                pp = self.cache.get(scene)
            except SceneLoadError as e:
                tried.add(scene)
                self._note_load_failure(scene, e)
                continue
            return scene, pp, cands

    def _bucket(self, scene: str, pp, scene_cands: List[_Active]):
        """Adaptive sampling: ``(bucket, budget, n_buckets)`` of the next
        tile. Each request's rays are classified on its first coalesce
        touch (the scene's stats are resident by then) into one bucket per
        budget class plus a last bucket of the hinted-dead rays (always
        class 0: their score lies below the first edge), which coalesces
        across requests into tiles that resolve fully dead and skip the
        kernel. The bucket served is the best-ranked candidate's first
        one with rays left; the dead bucket renders at the lowest budget,
        so a ray of it that resolves alive renders at its own class's."""
        ar = self.adaptive.renderer(scene, pp)
        for a in scene_cands:
            if a.bucket_idx is None:
                cls = ar.classify_rays(a.rays_o, a.rays_d)
                hint = ar.dead_hint(a.rays_o, a.rays_d)
                a.bucket_idx = [np.nonzero((cls == c) & ~hint)[0]
                                for c in range(len(ar.budgets))]
                a.bucket_idx.append(np.nonzero(hint)[0])
                a.bucket_next = [0] * len(a.bucket_idx)
        a0 = scene_cands[0]
        bucket = next(c for c in range(len(a0.bucket_idx))
                      if len(a0.bucket_idx[c]) > a0.bucket_next[c])
        budget = int(ar.budgets[bucket] if bucket < len(ar.budgets)
                     else ar.budgets[0])
        return bucket, budget, len(ar.budgets) + 1

    def next_tile(self) -> Optional[_Tile]:
        """Coalesce ONE tile from the best loadable scene's pending
        requests in rank order; ``None`` when nothing is schedulable."""
        t_coalesce0 = self._clock()
        resolved = self._resolve_scene()
        if resolved is None:
            return None
        scene, pp, cands = resolved
        if scene != self._current_scene:
            self.stats["scene_switches"] += 1
            self._current_scene = scene
            self._sticky_run = 0
        self._sticky_run += 1

        now = self._clock()
        scene_cands = sorted((a for a in cands if a.req.scene_id == scene),
                             key=self._rank)
        # a tile is mode-pure: degraded (coarse-only) and full-quality
        # rays cannot share a dispatch program; under adaptive sampling
        # it is also budget-pure, every ray at its class's n_fine
        degraded = scene_cands[0].degraded
        bucket = budget = None
        if self.adaptive is not None and not degraded:
            bucket, budget, n_buckets = self._bucket(scene, pp, scene_cands)
        spans, chunks_o, chunks_d, n = [], [], [], 0
        for a in scene_cands:
            if a.degraded != degraded:
                continue
            if bucket is not None:
                avail, cur = a.bucket_idx[bucket], a.bucket_next[bucket]
                take = min(len(avail) - cur, self.tile_rays - n)
                if take <= 0:
                    continue
                idx = avail[cur:cur + take]
                spans.append((a, idx, take))
                chunks_o.append(a.rays_o[idx])
                chunks_d.append(a.rays_d[idx])
                a.bucket_next[bucket] = cur + take
            else:
                take = min(a.remaining, self.tile_rays - n)
                if take <= 0:
                    continue
                spans.append((a, a.next_ray, take))
                chunks_o.append(a.rays_o[a.next_ray:a.next_ray + take])
                chunks_d.append(a.rays_d[a.next_ray:a.next_ray + take])
            if a.service_start_s is None:
                a.service_start_s = now
            a.next_ray += take
            n += take
            if n == self.tile_rays:
                break
        # an adaptive bucket's last tile shrinks to the next power of two
        # (at least 32 rays): a 40-ray minority class is not padded to a
        # full tile, and the tile shapes stay few
        target = self.tile_rays
        if bucket is not None and n < target:
            target = min(target,
                         max(32, 1 << int(np.ceil(np.log2(max(n, 2))))))
        pad = target - n
        if pad:                       # tail tile: repeat the last real ray
            chunks_o.append(np.repeat(chunks_o[-1][-1:], pad, axis=0))
            chunks_d.append(np.repeat(chunks_d[-1][-1:], pad, axis=0))
            self.stats["padded_rays"] += pad
        tid = self._tile_seq
        self._tile_seq += 1
        tile = _Tile(scene, pp, spans, np.concatenate(chunks_o),
                     np.concatenate(chunks_d), n,
                     home_cell=self._route(scene, pp), degraded=degraded,
                     budget=budget,
                     dead_bucket=(bucket is not None
                                  and bucket == n_buckets - 1),
                     tid=tid)
        tr = self.tracer
        if tr.enabled:
            tr.complete("tile.coalesce", t_coalesce0, cat="tile", tile=tid,
                        scene=scene, rays=n, pad=pad, requests=len(spans),
                        degraded=degraded, budget_class=budget)
        m = getattr(self.stats, "m", None)
        if m is not None:
            m.coalesce_seconds.observe(self._clock() - t_coalesce0)
        return tile


def _gather_cost(tile: _Tile) -> dict:
    """The resident's weight-gather record of one dispatch of ``tile``: at
    its home cell, or unrouted (asked without one)."""
    if tile.home_cell is None:
        return tile.pp.tile_gather_cost()
    return tile.pp.tile_gather_cost(tile.home_cell)


# ---------------------------------------------------------------------------
class TileExecutor:
    """Layer 2 — dispatch. A ring of up to ``depth`` in-flight tile
    slots: ``dispatch`` enqueues the tile on the card and returns without
    waiting; the oldest slot is drained (its event waited on, its pixels
    handed to completion) only when the ring is full or at an explicit
    flush. ``depth=1`` drains every dispatch at once.

    A dispatch that RAISES, or a drained buffer with non-finite real rays,
    enters the synchronous retry ladder: up to ``max_tile_retries`` fresh
    dispatches with capped exponential backoff, then the oracle program,
    so ``dispatch``/``drain_one`` do not raise for these fault classes.
    The optional ``StragglerMonitor`` abandons and redispatches tiles past
    its deadline factor. A ``FaultPlan`` injects failures at exactly these
    boundaries; the ladder's oracle is never wrapped.

    ``percell``: routed tiles run on their home cell (staged weights, the
    cell's own CUDA stream), and the in-flight budget is counted per cell:
    each cell gets its own ``depth`` slots, so two cells hold different
    scenes' tiles at once instead of sharing one ring."""

    def __init__(self, completion: "CompletionSink", cache: SceneCache,
                 stats: dict, depth: int = 1, *,
                 faults: Optional[FaultPlan] = None,
                 straggler=None, max_tile_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 max_retry_backoff_s: float = 0.05,
                 check_finite: bool = True, clock=time.perf_counter,
                 sleep=time.sleep, tracer=None, percell: bool = False,
                 adaptive: Optional[AdaptiveSampling] = None):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.completion = completion
        # budget-stamped tiles render through their scene's
        # AdaptiveRenderer (budgeted n_fine + memo-dead rows)
        self.adaptive = adaptive
        self.cache = cache
        self.stats = stats
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.depth = int(depth)
        self.faults = faults
        self.straggler = straggler
        self.percell = bool(percell)
        # cell -> {"dispatches", "max_in_flight"} (per-cell dispatch)
        self.cell_stats: Dict[Optional[int], dict] = {}
        self.max_tile_retries = int(max_tile_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_retry_backoff_s = float(max_retry_backoff_s)
        self.check_finite = bool(check_finite)
        self._clock = clock
        self._sleep = sleep
        self._slots: deque = deque()    # (tile, handle, t0, extra_s, span)
        # (event, tracer clock, device index): see _device_clock
        self._anchor = None

    @property
    def in_flight(self) -> int:
        return len(self._slots)

    # ------------------------------------------------------- internals ----
    def _attempt(self, tile: _Tile, allow_straggle: bool = True):
        """ONE dispatch attempt through the fault plan. Returns
        ``(handle, gather_cost, injected_extra_latency_s)``; raises on an
        injected or real dispatch failure."""
        fault = (self.faults.draw_dispatch(allow_straggle=allow_straggle)
                 if self.faults is not None else None)
        if fault is not None and fault["kind"] == "dispatch_error":
            raise InjectedDispatchError(
                f"injected dispatch failure (tile scene={tile.scene_id})")
        if tile.budget is not None and self.adaptive is not None:
            # the tile renders at its class's n_fine with the memo-dead
            # rays masked out of K2 (an all-dead tile launches nothing)
            ar = self.adaptive.renderer(tile.scene_id, tile.pp)
            start = tile.pp.tile_start()
            rgb, info = ar.render_tile(tile.rays_o, tile.rays_d,
                                       budget=tile.budget,
                                       resolve_dead=tile.dead_bucket)
            self.adaptive.account(tile, info, self.stats)
            tr = self.tracer
            if tr.enabled:
                tr.event("tile.adaptive", cat="tile", tile=tile.tid,
                         budget_class=tile.budget, dead=info["dead"],
                         full_dead=info["full_dead"])
            handle = tile.pp.handle(rgb, start)
            cost = _gather_cost(tile)
        else:
            # the routing and tracing keywords only when in play: an
            # unrouted resident is called as one that never heard of cells
            kw = {}
            if tile.home_cell is not None:
                kw.update(home_cell=tile.home_cell, percell=self.percell)
            if self.tracer.enabled:
                kw.update(tracer=self.tracer, trace_attrs={
                    "tile": tile.tid, "scene": tile.scene_id})
            handle, cost = tile.pp.dispatch_tile(
                tile.rays_o, tile.rays_d, coarse_only=tile.degraded, **kw)
        extra = (fault["extra_s"]
                 if fault is not None and fault["kind"] == "straggle"
                 else 0.0)
        return handle, cost, extra

    def _is_finite(self, arr: np.ndarray, tile: _Tile) -> bool:
        """Real (non-pad) rays must be finite; checked when
        ``check_finite`` is on (the default) or faults are injected."""
        if not self.check_finite and self.faults is None:
            return True
        return bool(np.isfinite(arr[:tile.n_real]).all())

    def _bump_retries(self, tile: _Tile) -> None:
        for a, _, _ in tile.spans:
            if not a.terminal:
                a.retries += 1

    def _resolve_sync(self, tile: _Tile):
        """The synchronous retry ladder for a tile whose primary dispatch
        failed or drained corrupt: up to ``max_tile_retries`` fresh
        dispatches (each a new fault-plan event, with capped exponential
        backoff between them), then the oracle program, which the fault
        plan never touches. Returns ``(finite rgb ndarray, gather_cost)``."""
        st = self.stats
        tr = self.tracer
        for attempt in range(self.max_tile_retries):
            st["tile_retries"] += 1
            self._bump_retries(tile)
            if tr.enabled:
                tr.event("tile.retry", cat="tile", tile=tile.tid,
                         attempt=attempt + 1)
            if self.retry_backoff_s > 0.0:
                self._sleep(min(self.retry_backoff_s * (2 ** attempt),
                                self.max_retry_backoff_s))
            try:
                handle, cost, _ = self._attempt(tile, allow_straggle=False)
            except Exception:
                # a boundary that must keep serving: any failed attempt
                # is counted and the ladder moves on to the next rung
                st["dispatch_errors"] += 1
                continue
            arr = handle.result()
            self._device_span(tile, handle)
            if self.faults is not None:
                bad = self.faults.corrupt_tile(arr)
                if bad is not None:
                    arr = bad
            if self._is_finite(arr, tile):
                return arr, cost
            st["corrupt_tiles"] += 1
        st["oracle_fallbacks"] += 1
        if tr.enabled:
            tr.event("tile.fallback", cat="tile", tile=tile.tid)
        for a, _, _ in tile.spans:
            if not a.terminal:
                a.fallbacks += 1
        pp = tile.pp
        rgb = (pp.render_tile(tile.rays_o, tile.rays_d, coarse_only=True)
               if tile.degraded
               else pp.render_tile_oracle(tile.rays_o, tile.rays_d))
        return rgb.cpu().numpy(), _gather_cost(tile)

    def _device_clock(self, tile: _Tile) -> None:
        """Once per traced engine, before its first tile on the card: the
        anchor that puts the tiles' CUDA events on the tracer's clock, a
        timing event recorded on the idle device and the tracer's clock
        read once it has completed."""
        if self._anchor is not None or tile.pp.device.type != "cuda":
            return
        torch.cuda.synchronize(tile.pp.device)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        event.synchronize()
        self._anchor = (event, self.tracer.clock(), tile.pp.device.index or 0)

    def _device_span(self, tile: _Tile, handle) -> None:
        """A drained tile's interval on the card as a complete span,
        ``tile.kernel`` (category ``device``, one Chrome track per
        device): from the event before its render to the event after its
        pixels' copy, on the tracer's clock. Traced runs on the card only;
        the span chain's validator does not read the name."""
        if not self.tracer.enabled or self._anchor is None:
            return
        anchor, t_host, index = self._anchor
        iv = handle.device_interval(anchor)
        if iv is not None:
            self.tracer.complete("tile.kernel", t_host + iv[0], cat="device",
                                 t1=t_host + iv[1], tile=tile.tid,
                                 device=index)

    def _account(self, tile: _Tile, cost: dict) -> None:
        st = self.stats
        st["dispatches"] += 1
        st["rays_rendered"] += tile.n_real
        st["plcore_gather_count"] += cost["layers"]
        st["plcore_gather_bytes"] += cost["bytes"]
        if tile.home_cell is not None and "routed_tiles" in st:
            st["routed_tiles"] += 1
        if tile.degraded:
            st["degraded_tiles"] += 1
        if "cell" in cost and "percell_tiles" in st:
            # a per-cell execution: the dispatch itself gathers nothing;
            # stage_* is nonzero only on the dispatch that staged the
            # (scene, cell) weights
            st["percell_tiles"] += 1
            if cost.get("stage_layers"):
                st["percell_stage_events"] += 1
                st["percell_stage_layers"] += cost["stage_layers"]
                st["percell_stage_bytes"] += cost["stage_bytes"]

    # --------------------------------------------------- per-cell slots ----
    def _cell_of(self, tile: _Tile) -> Optional[int]:
        """The in-flight ring a tile occupies: its home cell under per-cell
        dispatch, else the single global (None) ring."""
        return tile.home_cell if self.percell else None

    def _cell_in_flight(self, cell: Optional[int]) -> int:
        return sum(1 for s in self._slots if self._cell_of(s[0]) == cell)

    def _note_cell_dispatch(self, tile: _Tile) -> None:
        """Per-cell occupancy at dispatch time: the cell's dispatches and
        its peak of tiles in flight."""
        if not self.percell:
            return
        cell = self._cell_of(tile)
        n = self._cell_in_flight(cell)
        cs = self.cell_stats.setdefault(
            cell, {"dispatches": 0, "max_in_flight": 0})
        cs["dispatches"] += 1
        cs["max_in_flight"] = max(cs["max_in_flight"], n)
        st = self.stats
        if "percell_cells_active" in st:
            st["percell_cells_active"] = len(self.cell_stats)
        m = getattr(st, "m", None)
        if m is not None:
            label = "none" if cell is None else cell
            m.cell_dispatches.labels(cell=label).inc()
            m.cell_in_flight.labels(cell=label).set(n)
            m.cell_max_in_flight.labels(cell=label).set(cs["max_in_flight"])

    def drain_cell_one(self, cell: Optional[int]) -> bool:
        """Drain the OLDEST in-flight tile of ONE cell's ring (it may sit
        mid-deque: other cells' younger tiles stay in flight). Same
        recovery, scatter and unpin as ``drain_one``."""
        for i, s in enumerate(self._slots):
            if self._cell_of(s[0]) == cell:
                del self._slots[i]
                self._finish_slot(*s)
                return True
        return False

    def _update_service_ewma(self, dt: float) -> None:
        prev = self.stats.get("tile_service_s_ewma")
        self.stats["tile_service_s_ewma"] = (
            dt if not prev else 0.7 * prev + 0.3 * dt)
        m = getattr(self.stats, "m", None)
        if m is not None:
            m.service_seconds.observe(dt)

    # ----------------------------------------------------------- public ----
    def dispatch(self, tile: _Tile) -> None:
        """Issue one tile (without waiting), pin its scene for the life of
        the slot, account it, then drain down to ``depth - 1`` slots so at
        most ``depth`` tiles are ever enqueued. A dispatch-time failure is
        resolved synchronously through the retry ladder and never occupies
        a slot."""
        self.cache.pin(tile.scene_id, cell=self._cell_of(tile))
        tr = self.tracer
        if tr.enabled:
            self._device_clock(tile)
            tr.event("tile.dispatch", cat="tile", tile=tile.tid,
                     scene=tile.scene_id, slot=len(self._slots),
                     degraded=tile.degraded, home_cell=tile.home_cell)
        try:
            handle, cost, extra = self._attempt(tile)
        except Exception as e:
            # the dispatch boundary keeps serving: the failure is counted
            # and the tile goes down the retry ladder
            self.stats["dispatch_errors"] += 1
            if tr.enabled:
                tr.event("tile.dispatch_error", cat="tile", tile=tile.tid,
                         error=str(e)[:120])
            arr, cost = self._resolve_sync(tile)
            self._account(tile, cost)
            self.completion.scatter(tile, arr)
            self.cache.unpin(tile.scene_id, cell=self._cell_of(tile))
            return
        sp = (tr.begin("tile.device_compute", cat="tile", tile=tile.tid,
                       slot=len(self._slots))
              if tr.enabled else None)
        self._slots.append((tile, handle, self._clock(), extra, sp))
        self._account(tile, cost)
        self._note_cell_dispatch(tile)
        self.stats["max_in_flight"] = max(self.stats["max_in_flight"],
                                          len(self._slots))
        m = getattr(self.stats, "m", None)
        if m is not None:
            m.in_flight_tiles.set(len(self._slots))
        if self.percell:
            # the depth budget is per cell: this tile's ring drains when
            # its cell is full, other cells' tiles stay in flight
            cell = self._cell_of(tile)
            while self._cell_in_flight(cell) >= self.depth:
                self.drain_cell_one(cell)
        else:
            while len(self._slots) >= self.depth:
                self.drain_one()

    def drain_one(self) -> bool:
        """Materialize the OLDEST in-flight tile (the only wait in the
        loop), recover it if it drained corrupt or straggled, scatter it
        and release its scene pin. Does not raise for handled faults."""
        if not self._slots:
            return False
        self._finish_slot(*self._slots.popleft())
        return True

    def _finish_slot(self, tile, handle, t0, extra, sp) -> None:
        arr = handle.result()
        tr = self.tracer
        tr.end(sp)
        if tr.enabled:
            self._device_span(tile, handle)
            tr.event("tile.drain", cat="tile", tile=tile.tid)
        if self.faults is not None:
            bad = self.faults.corrupt_tile(arr)
            if bad is not None:
                arr = bad
        redispatched = False
        if self.straggler is not None:
            # the in-flight latency includes any injected straggle; past
            # the monitor's deadline the slow result is abandoned and the
            # tile redispatched instead of paying the stall
            verdict = self.straggler.record_step(
                self._clock() - t0 + extra)
            if verdict["deadline_exceeded"]:
                self.stats["straggler_redispatches"] += 1
                if tr.enabled:
                    tr.event("tile.straggler_redispatch", cat="tile",
                             tile=tile.tid)
                arr, _ = self._resolve_sync(tile)
                redispatched = True
            elif extra > 0.0:
                self._sleep(extra)    # the monitor missed it: pay the stall
                self.stats["straggle_wait_s"] += extra
        elif extra > 0.0:
            self._sleep(extra)
            self.stats["straggle_wait_s"] += extra
        if not redispatched and not self._is_finite(arr, tile):
            self.stats["corrupt_tiles"] += 1
            if tr.enabled:
                tr.event("tile.corrupt", cat="tile", tile=tile.tid)
            arr, _ = self._resolve_sync(tile)
        dt = self._clock() - t0
        m = getattr(self.stats, "m", None)
        if m is not None:
            m.inflight_seconds.observe(dt)
            m.in_flight_tiles.set(len(self._slots))
        self._update_service_ewma(dt)
        self.completion.scatter(tile, arr)
        self.cache.unpin(tile.scene_id, cell=self._cell_of(tile))


# ---------------------------------------------------------------------------
class CompletionSink:
    """Layer 3 — output. Scatters drained tiles to per-request
    framebuffers and completes requests out of order as their last ray
    lands, and owns TERMINATION: every request ends here exactly once."""

    def __init__(self, scheduler: TileScheduler, stats: dict, clock,
                 check_finite: bool = True, tracer=None):
        self.scheduler = scheduler
        self.stats = stats
        self._clock = clock
        self.check_finite = bool(check_finite)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.completed: Dict[int, RenderResult] = {}
        self.completion_order: List[int] = []

    def scatter(self, tile: _Tile, rgb: np.ndarray) -> None:
        t0 = self._clock()
        off = 0
        late = 0
        for a, start, take in tile.spans:
            if a.terminal:
                # the request already reached a terminal status (expired
                # or rejected mid-flight): its late pixels drop
                self.stats["late_rays"] += take
                late += take
                off += take
                continue
            if isinstance(start, np.ndarray):
                # an adaptive bucket's rays of this request, by index
                a.fb[start] = rgb[off:off + take]
            else:
                a.fb[start:start + take] = rgb[off:off + take]
            a.n_done += take
            off += take
            if a.n_done == a.n_rays:
                self._complete(a)
        tr = self.tracer
        if tr.enabled:
            tr.complete("tile.scatter", t0, cat="tile", tile=tile.tid,
                        scene=tile.scene_id, late=late)
        m = getattr(self.stats, "m", None)
        if m is not None:
            m.scatter_seconds.observe(self._clock() - t0)

    def _finish(self, a: _Active, status: str,
                error: Optional[str] = None) -> None:
        a.terminal = True
        if a in self.scheduler.queue:
            self.scheduler.remove(a)
        hw = a.req.hw
        res = RenderResult(
            request_id=a.rid, scene_id=a.req.scene_id,
            image=a.fb.reshape(hw, hw, 3), n_rays=a.n_rays,
            submit_s=a.submit_s,
            service_start_s=(a.submit_s if a.service_start_s is None
                             else a.service_start_s),
            complete_s=self._clock(),
            dispatch_baseline=-(-a.n_rays // self.scheduler.tile_rays),
            status=status, error=error, retries=a.retries,
            fallbacks=a.fallbacks)
        self.completed[a.rid] = res
        self.completion_order.append(a.rid)
        self.stats["requests_completed"] += 1
        counts = self.stats["status_counts"]
        counts[status] = counts.get(status, 0) + 1
        sp = a.trace_span
        if sp is not None:
            a.trace_span = None
            tr = self.tracer
            tr.event("request.complete", cat="request", request=a.rid,
                     status=status)
            tr.end(sp, status=status)
        m = getattr(self.stats, "m", None)
        if m is not None:
            m.queue_depth.set(len(self.scheduler.queue))
            if res.delivered:
                m.request_latency_seconds.observe(res.latency_s)

    def _complete(self, a: _Active) -> None:
        if self.check_finite and not np.isfinite(a.fb).all():
            # a fully scattered framebuffer with a non-finite pixel: the
            # recovery ladder guarantees finite tiles, so this is an
            # engine invariant violation (a scatter gap or a leaked
            # sentinel), not a handled fault: raise, do not ship it
            bad = int((~np.isfinite(a.fb)).any(axis=-1).sum())
            raise RuntimeError(
                f"delivered framebuffer for request {a.rid} "
                f"(scene {a.req.scene_id!r}) has {bad} non-finite pixels "
                f"— NaN scatter sentinel not fully overwritten")
        self._finish(a, "degraded" if a.degraded else "ok")

    def terminate(self, a: _Active, status: str,
                  error: Optional[str] = None) -> None:
        """Force a request to a terminal status (expiry, rejection, dead
        scene). Idempotent: the first terminal status wins."""
        if a.terminal:
            return
        self._finish(a, status, error)


# ---------------------------------------------------------------------------
class RenderEngine:
    """Continuous-batching serving loop over a ``SceneCache``: the
    scheduler/executor/completion stack behind one facade.

    ``tile_rays`` is the fixed dispatch shape: every tile that reaches the
    card has exactly this many rays, and only a tail tile carries padding.
    ``pipeline_depth`` bounds the executor's in-flight slots (1 =
    synchronous; >= 2 overlaps host coalescing and scatter with the card's
    work). ``route_by_shard`` routes each scene's tiles to a home cell by
    the owner map of residents sharded over a cell list
    (``PackedPlcore(shard_mesh=...)``), and ``percell_dispatch`` (with
    it) runs every routed tile on its home cell: staged weights, the
    cell's own CUDA stream, ``pipeline_depth`` slots per cell
    (``percell_report``).

    Fault-tolerance knobs (all default to the fault-free behavior):
    ``max_queue`` bounds the request queue; requests with a ``deadline_s``
    get SLO admission control and expiry; ``aging_tiles`` arms
    deterministic priority aging; ``degrade_on_overload`` arms coarse-only
    rendering for low-priority requests under backlog;
    ``max_tile_retries``/``retry_backoff_s`` shape the retry ladder;
    ``faults`` injects a seeded ``FaultPlan``; ``straggler_mitigation``
    wires the ``runtime.straggler`` monitor into the executor (default: on
    exactly when faults are injected); ``check_finite`` asserts delivered
    framebuffers are finite; ``tile_service_prior_s`` seeds the admission
    estimate before any tile has drained.

    ``adaptive_sampling`` arms ASDR (module docstring): ``budget_classes``
    (ascending; default ``default_budget_classes(cfg.n_fine)``),
    ``memo_mb`` per-scene trunk-memo capacity, ``adaptive_grid_res`` and
    ``adaptive_probe_hw`` size the load-time probe. It needs fused-kernel
    scenes and cannot be combined with ``degrade_on_overload`` (both
    rewrite the per-ray sample budget)."""

    def __init__(self, cache: SceneCache, *, tile_rays: int = 512,
                 max_sticky_tiles: int = 64, clock=time.perf_counter,
                 pipeline_depth: int = 1, route_by_shard: bool = False,
                 percell_dispatch: bool = False,
                 max_queue: Optional[int] = None,
                 aging_tiles: Optional[int] = None,
                 degrade_on_overload: bool = False,
                 degrade_queue_tiles: int = 8,
                 degrade_max_priority: int = 0,
                 max_load_failures: int = 3,
                 max_tile_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 faults: Optional[FaultPlan] = None,
                 straggler_mitigation: Optional[bool] = None,
                 straggler_cfg=None,
                 check_finite: bool = True,
                 tile_service_prior_s: Optional[float] = None,
                 adaptive_sampling: bool = False,
                 budget_classes=None,
                 memo_mb: float = 32.0,
                 adaptive_grid_res: int = 32,
                 adaptive_probe_hw: int = 8,
                 tracer=None, registry=None):
        if percell_dispatch and not route_by_shard:
            raise ValueError("percell_dispatch executes tiles on their "
                             "routed home cell — pass route_by_shard=True")
        if adaptive_sampling and (route_by_shard or percell_dispatch):
            # the probe and the memo read the replicated raw trunk params
            raise ValueError("adaptive_sampling is a replicated "
                             "single-cell feature — incompatible with "
                             "route_by_shard / percell_dispatch")
        if adaptive_sampling and degrade_on_overload:
            raise ValueError("adaptive_sampling and degrade_on_overload "
                             "both rewrite the per-ray sample budget — "
                             "arm one")
        self.cache = cache
        self.percell_dispatch = bool(percell_dispatch)
        self.faults = faults
        self._clock = clock
        # a per-engine registry backs the stats dict; the tracer records
        # the request/tile lifecycle (NULL_TRACER no-ops when off)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.stats = engine_stats_view(self.registry)
        # the routing and per-cell blocks are bound only when armed, so the
        # default stats keep their keys
        if route_by_shard:
            extend_stats_view(self.stats, ROUTING_STATS_SCHEMA)
        if percell_dispatch:
            extend_stats_view(self.stats, PERCELL_STATS_SCHEMA)
        self.adaptive: Optional[AdaptiveSampling] = None
        if adaptive_sampling:
            # the sampling block is bound only when armed, so the default
            # stats keep their keys
            extend_stats_view(self.stats, SAMPLING_STATS_SCHEMA)
            self.adaptive = AdaptiveSampling(
                cache, budgets=budget_classes, memo_mb=memo_mb,
                grid_res=adaptive_grid_res, probe_hw=adaptive_probe_hw)
        cache.tracer = self.tracer
        self.scheduler = TileScheduler(
            cache, tile_rays=tile_rays, max_sticky_tiles=max_sticky_tiles,
            stats=self.stats, clock=clock, route_by_shard=route_by_shard,
            max_queue=max_queue,
            aging_tiles=aging_tiles,
            degrade_on_overload=degrade_on_overload,
            degrade_queue_tiles=degrade_queue_tiles,
            degrade_max_priority=degrade_max_priority,
            max_load_failures=max_load_failures,
            tile_service_prior_s=tile_service_prior_s,
            adaptive=self.adaptive, tracer=self.tracer)
        self.completion = CompletionSink(self.scheduler, self.stats, clock,
                                         check_finite=check_finite,
                                         tracer=self.tracer)
        if straggler_mitigation is None:
            straggler_mitigation = faults is not None
        monitor = None
        if straggler_mitigation:
            from repro_torch.runtime.straggler import (StragglerConfig,
                                                       StragglerMonitor)
            monitor = StragglerMonitor(
                straggler_cfg if straggler_cfg is not None
                else StragglerConfig(warmup_steps=2, deadline_factor=4.0,
                                     ewma_alpha=0.2))
        self.executor = TileExecutor(
            self.completion, cache, self.stats, depth=pipeline_depth,
            faults=faults, straggler=monitor,
            max_tile_retries=max_tile_retries,
            retry_backoff_s=retry_backoff_s,
            check_finite=check_finite, clock=clock, tracer=self.tracer,
            percell=percell_dispatch, adaptive=self.adaptive)
        # admission control needs the in-flight count; termination needs
        # the sink
        self.scheduler.completion = self.completion
        self.scheduler.executor = self.executor

    # ------------------------------------------------------------ queue ----
    @property
    def tile_rays(self) -> int:
        return self.scheduler.tile_rays

    @property
    def pipeline_depth(self) -> int:
        return self.executor.depth

    @property
    def pending(self) -> int:
        """Requests not yet completed (queued, partly tiled, or fully in
        flight awaiting their scatter)."""
        return len(self.scheduler.queue)

    @property
    def pending_rays(self) -> int:
        return sum(a.remaining for a in self.scheduler.queue)

    @property
    def in_flight_tiles(self) -> int:
        return self.executor.in_flight

    @property
    def completed(self) -> Dict[int, RenderResult]:
        return self.completion.completed

    @property
    def completion_order(self) -> List[int]:
        return self.completion.completion_order

    def submit(self, req: RenderRequest) -> int:
        """Enqueue a request; returns its request id. Admission control
        may terminate it at once (status ``rejected``): the result is
        then already in ``completed``."""
        return self.scheduler.submit(req)

    # ------------------------------------------------------------- loop ----
    def step(self) -> bool:
        """One engine iteration: expire overdue requests, then coalesce
        and dispatch the next tile if any request has rays to hand out,
        else drain one in-flight slot. Returns False only when idle (no
        schedulable rays AND nothing in flight). Does not raise for
        handled fault classes."""
        self.scheduler.expire(self._clock())
        tile = self.scheduler.next_tile()
        if tile is not None:
            self.executor.dispatch(tile)
            return True
        if self.executor.in_flight:
            self.executor.drain_one()
            return True
        return False

    def take(self, request_id: int) -> RenderResult:
        """Pop a completed result, releasing its framebuffer."""
        return self.completion.completed.pop(request_id)

    def drain(self, max_steps: Optional[int] = None) -> int:
        """Run until idle: queue empty AND every in-flight slot flushed
        (or ``max_steps``); returns the steps taken."""
        steps = 0
        while ((self.scheduler.queue or self.executor.in_flight)
               and (max_steps is None or steps < max_steps)):
            self.step()
            steps += 1
        return steps

    # ------------------------------------------------------- reporting ----
    def robustness(self) -> dict:
        """The fault accounting: per-status terminal counts, goodput
        (delivered ok or degraded / all terminal), the retry/fallback
        ladder counters and, with a ``FaultPlan``, what it injected."""
        st = self.stats
        counts = dict(st["status_counts"])
        n = sum(counts.values())
        good = counts.get("ok", 0) + counts.get("degraded", 0)
        out = {
            "status_counts": counts,
            "goodput": round(good / n, 4) if n else None,
            "tile_retries": st["tile_retries"],
            "oracle_fallbacks": st["oracle_fallbacks"],
            "corrupt_tiles": st["corrupt_tiles"],
            "dispatch_errors": st["dispatch_errors"],
            "scene_load_errors": st["scene_load_errors"],
            "scene_load_fail_fasts": st["scene_load_fail_fasts"],
            "straggler_redispatches": st["straggler_redispatches"],
            "degraded_requests": st["degraded_requests"],
            "late_rays": st["late_rays"],
        }
        if self.faults is not None:
            out["faults_injected"] = self.faults.summary()
        return out

    def percell_report(self) -> Optional[dict]:
        """The per-cell dispatch summary (``None`` unless the engine runs
        with ``percell_dispatch``): per-cell dispatches and peak in-flight
        tiles, and the one-time staging totals."""
        if not self.percell_dispatch:
            return None
        st = self.stats
        cells = {str(c): dict(v)
                 for c, v in sorted(self.executor.cell_stats.items(),
                                    key=lambda kv: (kv[0] is None, kv[0]))}
        return {
            "cells": cells,
            "percell_tiles": st["percell_tiles"],
            "stage_events": st["percell_stage_events"],
            "stage_layers": st["percell_stage_layers"],
            "stage_bytes": st["percell_stage_bytes"],
            "cells_active": st["percell_cells_active"],
        }

    def sampling_report(self) -> Optional[dict]:
        """The adaptive-sampling summary (``None`` unless the engine runs
        with ``adaptive_sampling``): the engine-wide totals of the sampling
        stats block, the host time of the density probes, and per-scene
        budget histograms, memo traffic and host times."""
        if self.adaptive is None:
            return None
        st = self.stats
        return {
            "adaptive_tiles": st["adaptive_tiles"],
            "full_dead_tiles": st["full_dead_tiles"],
            "dead_rays": st["dead_rays"],
            "dead_ray_fraction": st["dead_ray_fraction"],
            "skipped_fine_samples": st["skipped_fine_samples"],
            "memo_hits": st["memo_hits"],
            "memo_misses": st["memo_misses"],
            "memo_evictions": st["memo_evictions"],
            "memo_topup_voxels": st["memo_topup_voxels"],
            "memo_resident_mb": st["memo_resident_mb"],
            "probe_s": self.adaptive.probe_s,
            "scenes": self.adaptive.report(),
        }
