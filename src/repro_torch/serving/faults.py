"""Deterministic seeded fault injection for the serving engine.

A serving deployment sees loader crashes, corrupted tile outputs (a
flipped bit in device memory, a NaN-poisoned accumulator) and straggling
dispatches. The engine's recovery paths for those (``serving.engine``:
per-tile retry, oracle fallback, loader backoff, straggler redispatch) are
only real if they are exercised; this module makes each of them
reproducibly triggerable.

* **Seeded and deterministic.** Every fault site draws from its own
  ``np.random.RandomState`` stream, one draw per event (dispatch attempt,
  tile materialization, loader call), seeded as the reference package's
  ``serving.faults`` seeds them: the same ``FaultConfig`` injects the
  same fault sequence there and here.
* **Faults are injected at the engine's trust boundaries**: the dispatch
  call (raises), the drained tile buffer (non-finite pixels), the scene
  loader (raises) and the tile's in-flight latency (straggler). The
  engine's oracle rung is not wrapped: it is the path recovery falls
  back to.
* **Corruption is applied to a copy** of the drained buffer; a retry
  re-renders the same rays through the same weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


class InjectedDispatchError(RuntimeError):
    """A FaultPlan-injected tile dispatch failure."""


class InjectedLoaderError(RuntimeError):
    """A FaultPlan-injected scene loader failure."""


@dataclass(frozen=True)
class FaultConfig:
    """Per-site fault rates. All default to 0 (a no-op plan)."""
    seed: int = 0
    dispatch_error_rate: float = 0.0   # dispatch call raises
    corrupt_rate: float = 0.0          # drained tile gets NaN/Inf pixels
    loader_error_rate: float = 0.0     # scene loader raises
    straggler_rate: float = 0.0        # dispatch gets artificial latency
    straggler_extra_s: float = 0.25    # the injected extra latency
    corrupt_inf_fraction: float = 0.5  # Inf vs NaN mix for corrupt rows
    # host-level event site (multi-host cluster only): one draw per tile
    # placement on a host, from that host's own seeded stream, so host 1's
    # fate does not depend on how many tiles host 0 served
    host_kill_rate: float = 0.0        # the whole host dies (failover)
    host_slow_rate: float = 0.0        # this dispatch pays extra latency
    host_slow_extra_s: float = 0.25    # ... this much

    @classmethod
    def chaos(cls, seed: int = 0) -> "FaultConfig":
        """The canonical chaos mix: every fault class enabled at rates
        high enough that a ~10-request trace exercises each recovery
        path, low enough that goodput stays at or above 0.75."""
        return cls(seed=seed, dispatch_error_rate=0.15, corrupt_rate=0.15,
                   loader_error_rate=0.25, straggler_rate=0.1)

    @classmethod
    def cluster_chaos(cls, seed: int = 0) -> "FaultConfig":
        """The canonical multi-host chaos mix: the single-host classes at
        slightly lower rates plus host-slow events (per-host degradation
        the health layer must flag). Host kills are left to explicit
        ``HostEvent`` schedules (serve ``--host-kill``, loadgen overload
        traces): a seeded kill early in a short trace can leave no alive
        host, which is another scenario than the goodput-gated chaos
        run."""
        return cls(seed=seed, dispatch_error_rate=0.1, corrupt_rate=0.1,
                   loader_error_rate=0.2, straggler_rate=0.05,
                   host_slow_rate=0.15, host_slow_extra_s=0.05)


class FaultPlan:
    """One deterministic fault schedule. Sites draw independently:

    * ``draw_dispatch()`` — one draw per tile dispatch attempt; returns
      ``None`` (healthy), ``{"kind": "dispatch_error"}`` (the executor
      should see a raise) or ``{"kind": "straggle", "extra_s": ...}``.
    * ``corrupt_tile(rgb)`` — one draw per drained tile; returns a
      corrupted COPY (NaN/Inf rows) or ``None``.
    * ``loader_fault(scene_id)`` / ``wrap_loader(loader)`` — one draw
      per loader invocation; the wrapper raises ``InjectedLoaderError``
      on a fault draw.
    * ``draw_host_event(host_id)`` — one draw per tile placement on a
      cluster host, from that host's own stream (host kill or slow-down).

    ``summary()`` reports per-site draw and injection counts.
    """

    def __init__(self, cfg: FaultConfig = FaultConfig()):
        self.cfg = cfg
        self._dispatch_rng = np.random.RandomState(cfg.seed)
        self._corrupt_rng = np.random.RandomState(cfg.seed + 1)
        self._loader_rng = np.random.RandomState(cfg.seed + 2)
        self._host_rngs: dict = {}     # host id -> its own event stream
        self.draws = {"dispatch": 0, "corrupt": 0, "loader": 0, "host": 0}
        self.injected = {"dispatch_error": 0, "straggle": 0, "corrupt": 0,
                         "loader_error": 0, "host_kill": 0, "host_slow": 0}

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def draw_dispatch(self, *, allow_straggle: bool = True) -> Optional[dict]:
        """Draw the fate of ONE dispatch attempt. Retries draw again, so
        recovery can succeed. ``allow_straggle=False`` (the synchronous
        retry ladder) still consumes the draw but reports a straggle as
        healthy: a blocking retry has no in-flight window to straggle in."""
        self.draws["dispatch"] += 1
        u = float(self._dispatch_rng.random_sample())
        c = self.cfg
        if u < c.dispatch_error_rate:
            self.injected["dispatch_error"] += 1
            return {"kind": "dispatch_error"}
        if u < c.dispatch_error_rate + c.straggler_rate:
            if not allow_straggle:
                return None
            self.injected["straggle"] += 1
            return {"kind": "straggle", "extra_s": c.straggler_extra_s}
        return None

    def draw_host_event(self, host_id: int) -> Optional[dict]:
        """Draw the fate of ONE tile placement on host ``host_id``, from
        that host's own seeded stream (seed + 1000 + host id): ``None``
        (healthy), ``{"kind": "host_kill"}`` (the host dies now: the
        cluster re-queues its in-flight tiles to other hosts) or
        ``{"kind": "host_slow", "extra_s": ...}`` (this dispatch pays
        extra latency, for the per-host EWMA and heartbeat layer to
        notice). Per-host streams keep a host's fault schedule independent
        of how the scheduler interleaved the other hosts' work."""
        self.draws["host"] += 1
        rng = self._host_rngs.get(host_id)
        if rng is None:
            rng = self._host_rngs[host_id] = np.random.RandomState(
                self.cfg.seed + 1000 + int(host_id))
        u = float(rng.random_sample())
        c = self.cfg
        if u < c.host_kill_rate:
            self.injected["host_kill"] += 1
            return {"kind": "host_kill"}
        if u < c.host_kill_rate + c.host_slow_rate:
            self.injected["host_slow"] += 1
            return {"kind": "host_slow", "extra_s": c.host_slow_extra_s}
        return None

    def corrupt_tile(self, rgb: np.ndarray) -> Optional[np.ndarray]:
        """Maybe corrupt ONE drained tile: returns a poisoned COPY (the
        original untouched) with a seeded subset of rows set to NaN or
        +/-Inf, or ``None`` for a healthy draw."""
        self.draws["corrupt"] += 1
        if float(self._corrupt_rng.random_sample()) >= self.cfg.corrupt_rate:
            return None
        self.injected["corrupt"] += 1
        arr = np.array(rgb, copy=True)
        n = int(self._corrupt_rng.randint(1, max(2, arr.shape[0] // 4)))
        idx = self._corrupt_rng.choice(arr.shape[0], size=min(n, arr.shape[0]),
                                       replace=False)
        use_inf = (float(self._corrupt_rng.random_sample())
                   < self.cfg.corrupt_inf_fraction)
        arr[idx] = np.inf if use_inf else np.nan
        return arr

    def loader_fault(self, scene_id: str) -> bool:
        """One draw per loader invocation."""
        self.draws["loader"] += 1
        hit = (float(self._loader_rng.random_sample())
               < self.cfg.loader_error_rate)
        if hit:
            self.injected["loader_error"] += 1
        return hit

    def wrap_loader(self, loader: Callable) -> Callable:
        """Wrap a SceneCache loader so a fault draw raises
        ``InjectedLoaderError`` BEFORE the real loader runs — the cache
        must end such a call with no partial entry resident."""
        def flaky(scene_id: str):
            if self.loader_fault(scene_id):
                raise InjectedLoaderError(
                    f"injected loader fault for scene {scene_id!r}")
            return loader(scene_id)
        return flaky

    def summary(self) -> dict:
        return {"seed": self.cfg.seed, "draws": dict(self.draws),
                "injected": dict(self.injected),
                "total_injected": self.total_injected}
