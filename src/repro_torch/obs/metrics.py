"""Typed metrics registry — the single source of truth for the serving
engine's counters.

Three metric kinds, Prometheus-shaped:

* ``Counter``   — monotonically accumulated value (int or float).
* ``Gauge``     — last-set value; ``None`` means "no observation yet"
  (the serving EWMA idiom).
* ``Histogram`` — fixed log-spaced buckets (``log_buckets``), plus
  running sum/count; read cumulatively (``le`` convention).

Each registered name is a ``MetricFamily``; ``family.labels(status="ok")``
returns the per-label-set child, and the unlabeled default child backs
``family.inc/set/observe`` directly. Registration is get-or-create; a kind
mismatch raises.

``StatsView`` is a ``dict`` subclass whose ``__setitem__`` writes through
to the backing registry metric. The engine's ``stats`` dict is one of
these, built from ``ENGINE_STATS_SCHEMA``: key order, value types and every
``stats["k"] += 1`` / ``stats.get`` / ``dict(stats)`` call site behave as
with a plain dict, while the registry sees every mutation.

Module-level counters (``kernels.ops`` packs and dispatches, the kernel
wrappers' launches) back onto ``global_registry()``, one process-wide
registry; ``CountsView`` is the dict face of a labeled counter family.

A copy of what the single-host engine needs from the reference package's
``obs.metrics``; the port imports nothing of the reference.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "StatsView", "CountsView", "log_buckets", "global_registry",
    "engine_stats_view", "extend_stats_view", "ENGINE_STATS_SCHEMA",
    "CLUSTER_STATS_SCHEMA", "SAMPLING_STATS_SCHEMA", "ROUTING_STATS_SCHEMA",
    "PERCELL_STATS_SCHEMA", "EngineMetrics",
    "TIME_BUCKETS",
    "DEPTH_BUCKETS",
]


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced histogram upper bounds from ``lo`` to >= ``hi``,
    ``per_decade`` buckets per factor of 10, computed from integer
    exponents so the same arguments always give the same edges."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    e0 = round(math.log10(lo) * per_decade)
    n = math.ceil(math.log10(hi / lo) * per_decade)
    return tuple(10.0 ** ((e0 + i) / per_decade) for i in range(n + 1))


#: Latency buckets: 10 microseconds to 100 seconds, 4 per decade.
TIME_BUCKETS = log_buckets(1e-5, 1e2, per_decade=4)
#: Occupancy buckets (queue depth, in-flight tiles): 1 .. 4096, powers of 2.
DEPTH_BUCKETS = tuple(float(2 ** i) for i in range(13))


class Counter:
    """Accumulated value; ``value`` is writable so the StatsView
    write-through can mirror ``stats["k"] += 1`` exactly."""
    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


class Gauge:
    """Last-set value; ``None`` = no observation yet."""
    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = v


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` counts observations with
    ``v <= bounds[i]``; the final slot is the +Inf overflow bucket."""
    kind = "histogram"
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> List[int]:
        """Prometheus-style cumulative counts, one per bound + +Inf."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One registered name: unlabeled default child + labeled children
    created on demand, keyed by the sorted (label, str(value)) tuple."""

    def __init__(self, name: str, kind: str, help: str = "",
                 unit: str = "", buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.unit = unit
        self.buckets = tuple(buckets) if buckets is not None else None
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _make(self):
        if self.kind == "histogram":
            return Histogram(self.buckets or TIME_BUCKETS)
        return _KINDS[self.kind]()

    def labels(self, **kv):
        key = tuple(sorted((k, str(v)) for k, v in kv.items()))
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._make()
        return child

    def children(self):
        """(label-tuple, child) pairs, insertion-ordered."""
        return list(self._children.items())

    @property
    def default(self):
        return self.labels()

    def inc(self, n=1):
        self.default.inc(n)

    def set(self, v):
        self.default.set(v)

    def observe(self, v):
        self.default.observe(v)

    @property
    def value(self):
        return self.default.value

    @value.setter
    def value(self, v):
        self.default.value = v


class MetricsRegistry:
    """Insertion-ordered name -> MetricFamily map. Get-or-create: a
    second registration of the same name returns the existing family
    (a kind or bucket mismatch raises)."""

    def __init__(self):
        self._families: Dict[str, MetricFamily] = {}

    def _register(self, name: str, kind: str, help: str, unit: str,
                  buckets=None) -> MetricFamily:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam.kind}, not {kind}")
            if kind == "histogram" and buckets is not None \
                    and fam.buckets != tuple(buckets):
                raise ValueError(f"histogram {name!r} re-registered with "
                                 f"different buckets")
            return fam
        fam = MetricFamily(name, kind, help=help, unit=unit, buckets=buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "", unit: str = "") \
            -> MetricFamily:
        return self._register(name, "counter", help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") \
            -> MetricFamily:
        return self._register(name, "gauge", help, unit)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets: Tuple[float, ...] = TIME_BUCKETS) -> MetricFamily:
        return self._register(name, "histogram", help, unit, buckets=buckets)

    def families(self) -> List[MetricFamily]:
        return list(self._families.values())

    def get(self, name: str) -> Optional[MetricFamily]:
        return self._families.get(name)


_GLOBAL: Optional[MetricsRegistry] = None


def global_registry() -> MetricsRegistry:
    """The process-wide registry behind the module-level counters (kernel
    packs, dispatches and launches). Per-engine counters live in
    per-engine registries; the exporters merge both."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MetricsRegistry()
    return _GLOBAL


class CountsView(dict):
    """A dict of counts whose writes mirror into one labeled counter
    family, a child per key (``family{label=key}``): the kernel wrappers'
    launch counts. Reads, equality and ``dict(view)`` are a plain dict's;
    ``clear`` zeroes the children before it empties the dict."""

    def __init__(self, family: MetricFamily, label: str, keys=()):
        super().__init__()
        object.__setattr__(self, "_family", family)
        object.__setattr__(self, "_label", label)
        for k in keys:
            self[k] = 0

    def __setitem__(self, key, value):
        self._family.labels(**{self._label: key}).value = value
        dict.__setitem__(self, key, value)

    def update(self, *args, **kw):
        # dict.update bypasses __setitem__ at the C level; route it
        for k, v in dict(*args, **kw).items():
            self[k] = v

    def clear(self):
        for k in list(self):
            self._family.labels(**{self._label: k}).value = 0
        dict.clear(self)


# The engine's stats schema, one tuple per key in report order:
# (key, kind, initial value, help)
ENGINE_STATS_SCHEMA = (
    ("dispatches", "counter", 0, "tiles actually issued"),
    ("dispatch_baseline", "counter", 0,
     "sum ceil(n_rays/tile) per request"),
    ("rays_rendered", "counter", 0, "real rays dispatched"),
    ("padded_rays", "counter", 0, "tail-tile filler rays"),
    ("scene_switches", "counter", 0, "resident-weight changes"),
    ("requests_completed", "counter", 0,
     "requests in ANY terminal status"),
    ("status_counts", "status", None, "terminal status -> count"),
    ("plcore_gather_count", "counter", 0, "remote weight-layer fetches"),
    ("plcore_gather_bytes", "counter", 0, "... and their bytes"),
    ("max_in_flight", "gauge", 0, "peak executor slot occupancy"),
    ("dispatch_errors", "counter", 0, "dispatch attempts that raised"),
    ("corrupt_tiles", "counter", 0, "drains with non-finite real rays"),
    ("tile_retries", "counter", 0, "retry-ladder attempts"),
    ("oracle_fallbacks", "counter", 0,
     "tiles resolved by the oracle rung"),
    ("scene_load_errors", "counter", 0, "real loader failures seen"),
    ("scene_load_fail_fasts", "counter", 0,
     "backoff short-circuits seen"),
    ("straggler_redispatches", "counter", 0,
     "abandoned-slow-tile redispatches"),
    ("straggle_wait_s", "counter", 0.0, "injected stalls actually paid"),
    ("degraded_requests", "counter", 0, "overload-degraded requests"),
    ("degraded_tiles", "counter", 0, "coarse-only tiles dispatched"),
    ("late_rays", "counter", 0, "scatters onto terminal requests"),
    ("tile_service_s_ewma", "gauge", None,
     "admission-control service estimator"),
)

# The cluster engine's stats block, the reference's, for the multi-host
# engine still to port (ROADMAP queue 1 item 4).
CLUSTER_STATS_SCHEMA = (
    ("cross_host_redispatches", "counter", 0,
     "tiles recovered on another host"),
    ("host_kills", "counter", 0, "hosts declared dead"),
    ("host_slow_events", "counter", 0, "slow-down events applied"),
    ("requeued_tiles", "counter", 0, "tiles abandoned by a dead host"),
    ("quarantines", "counter", 0, "(host, scene) windows opened"),
    ("quarantine_probes", "counter", 0, "failed recovery probes"),
    ("quarantine_recoveries", "counter", 0, "lifted quarantines"),
    ("affinity_migrations", "counter", 0,
     "drain-time residency handoffs"),
    ("heartbeat_timeouts", "counter", 0, "stale-beat host kills"),
    ("slow_host_flags", "counter", 0, "healthy -> suspect transitions"),
    ("host_drains", "counter", 0, "graceful host exits"),
    ("host_rejoins", "counter", 0, "hosts restored to the pool"),
    ("failovers", "counter", 0, "re-queued tiles re-dispatched"),
    ("failover_latency_s", "counter", 0.0,
     "summed requeue -> redispatch latency"),
)

# The shard-routing block, bound by ``extend_stats_view`` only when an
# engine runs with ``route_by_shard`` (the reference keeps this key in its
# engine block; here the default stats keep the keys they had before
# routing was ported).
ROUTING_STATS_SCHEMA = (
    ("routed_tiles", "counter", 0, "tiles with a home cell assigned"),
)

# The per-cell dispatch block, bound by ``extend_stats_view`` only when an
# engine runs with ``percell_dispatch``, as in the reference.
PERCELL_STATS_SCHEMA = (
    ("percell_tiles", "counter", 0,
     "tiles executed through a per-cell program"),
    ("percell_stage_events", "counter", 0,
     "(scene, cell) one-time weight stagings performed"),
    ("percell_stage_layers", "counter", 0,
     "remote trunk layers paid by those stagings"),
    ("percell_stage_bytes", "counter", 0, "... and their bytes"),
    ("percell_cells_active", "gauge", 0,
     "distinct cells that have executed a tile"),
)

# The adaptive-sampling block, bound by ``extend_stats_view`` only when an
# engine runs with ``adaptive_sampling``, so the default stats keep their
# keys. The gauge ``dead_ray_fraction`` exports as
# ``engine_dead_ray_fraction``.
SAMPLING_STATS_SCHEMA = (
    ("adaptive_tiles", "counter", 0,
     "tiles dispatched through the adaptive (budget-bucketed) path"),
    ("full_dead_tiles", "counter", 0,
     "all-dead tiles resolved from the trunk memo without a kernel "
     "launch"),
    ("dead_rays", "counter", 0,
     "rays entering the fused kernel as dead rows (memo-resident, "
     "provably-empty frustums)"),
    ("skipped_fine_samples", "counter", 0,
     "fine-MLP samples skipped by dead rows at the tile's budget"),
    ("memo_topup_voxels", "counter", 0,
     "trunk rows computed by per-dispatch memo top-ups"),
    ("memo_hits", "counter", 0, "trunk-memo row lookups served"),
    ("memo_misses", "counter", 0, "trunk-memo row lookups missed"),
    ("memo_evictions", "counter", 0, "trunk-memo LRU evictions"),
    ("dead_ray_fraction", "gauge", 0.0,
     "dead rows / dispatched rays, cumulative over the run"),
    ("memo_resident_mb", "gauge", 0.0,
     "live trunk-memo bytes across resident scenes"),
)


class _StatusCounts(dict):
    """The nested ``status_counts`` dict, backed by a labeled counter
    family (``engine_requests_by_status_total{status=...}``); compares
    equal to plain dicts."""

    def __init__(self, family: MetricFamily):
        super().__init__()
        object.__setattr__(self, "_family", family)

    def __setitem__(self, status, value):
        self._family.labels(status=status).value = value
        dict.__setitem__(self, status, value)


class StatsView(dict):
    """dict-compatible stats whose writes mirror into registry metrics.

    Reads are plain dict reads; writes go through ``__setitem__``, which
    updates the bound metric first. ``dict(view)`` / ``json.dumps`` see
    exactly the values a plain dict would hold. The attached ``m`` (an
    :class:`EngineMetrics`) carries the histograms and occupancy gauges;
    engine layers reach it via ``getattr(stats, "m", None)`` so a plain
    dict still works."""

    def __init__(self, registry: MetricsRegistry, prefix: str = "engine"):
        super().__init__()
        object.__setattr__(self, "registry", registry)
        object.__setattr__(self, "_prefix", prefix)
        object.__setattr__(self, "_backing", {})
        object.__setattr__(self, "m", None)

    def bind_schema(self, schema) -> "StatsView":
        reg, prefix = self.registry, self._prefix
        for key, kind, init, help in schema:
            if kind == "status":
                fam = reg.counter(f"{prefix}_requests_by_status_total", help)
                dict.__setitem__(self, key, _StatusCounts(fam))
                continue
            if kind == "gauge":
                fam = reg.gauge(f"{prefix}_{key}", help)
            else:
                fam = reg.counter(f"{prefix}_{key}_total", help)
            metric = fam.default
            metric.value = init
            self._backing[key] = metric
            dict.__setitem__(self, key, init)
        return self

    def __setitem__(self, key, value):
        metric = self._backing.get(key)
        if metric is not None:
            metric.value = value
        dict.__setitem__(self, key, value)

    def update(self, *args, **kw):
        # dict.update bypasses __setitem__ at the C level; route it
        for k, v in dict(*args, **kw).items():
            self[k] = v


class EngineMetrics:
    """The derived per-phase instruments one engine owns: occupancy
    gauges and per-phase latency histograms. Units are seconds
    (histograms) and plain counts (gauges)."""

    def __init__(self, registry: MetricsRegistry, prefix: str = "engine"):
        self.queue_depth = registry.gauge(
            f"{prefix}_queue_depth", "queued (non-terminal) requests")
        self.in_flight_tiles = registry.gauge(
            f"{prefix}_in_flight_tiles", "occupied executor slots")
        self.queue_depth_hist = registry.histogram(
            f"{prefix}_queue_depth_requests",
            "queue depth sampled at each submit", buckets=DEPTH_BUCKETS)
        self.coalesce_seconds = registry.histogram(
            f"{prefix}_coalesce_seconds",
            "scene resolve + ray coalescing per tile", unit="s")
        self.inflight_seconds = registry.histogram(
            f"{prefix}_tile_inflight_seconds",
            "dispatch enqueue -> drain materialization per tile", unit="s")
        self.service_seconds = registry.histogram(
            f"{prefix}_tile_service_seconds",
            "per-tile service time feeding the admission EWMA", unit="s")
        self.scatter_seconds = registry.histogram(
            f"{prefix}_scatter_seconds",
            "framebuffer scatter per drained tile", unit="s")
        self.request_latency_seconds = registry.histogram(
            f"{prefix}_request_latency_seconds",
            "submit -> terminal status per delivered request", unit="s")
        # per-cell families (per-cell dispatch runs): tiles and slot
        # occupancy by home cell
        self.cell_dispatches = registry.counter(
            f"{prefix}_cell_dispatches_total",
            "per-cell tiles dispatched through per-cell programs")
        self.cell_in_flight = registry.gauge(
            f"{prefix}_cell_in_flight_tiles",
            "occupied executor slots per home cell")
        self.cell_max_in_flight = registry.gauge(
            f"{prefix}_cell_max_in_flight_tiles",
            "peak executor slot occupancy per home cell")
        # per-budget-class families (adaptive-sampling runs): the budget
        # histogram behind the engine's sampling report, as
        # {budget_class=...} children
        self.budget_tiles = registry.counter(
            f"{prefix}_budget_tiles_total",
            "tiles dispatched per fine-sample budget class")
        self.budget_rays = registry.counter(
            f"{prefix}_budget_rays_total",
            "rays dispatched per fine-sample budget class")


def engine_stats_view(registry: MetricsRegistry) -> StatsView:
    """The RenderEngine stats dict: schema-derived and registry-backed,
    with :class:`EngineMetrics` attached as ``view.m``."""
    view = StatsView(registry).bind_schema(ENGINE_STATS_SCHEMA)
    object.__setattr__(view, "m", EngineMetrics(registry))
    return view


def extend_stats_view(view: StatsView, schema) -> StatsView:
    """Append a schema block (``SAMPLING_STATS_SCHEMA``,
    ``ROUTING_STATS_SCHEMA``, ``PERCELL_STATS_SCHEMA``) to an existing
    view: same registry, same write-through binding."""
    return view.bind_schema(schema)
