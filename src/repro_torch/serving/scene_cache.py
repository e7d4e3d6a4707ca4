"""Multi-scene weight cache: model residency for the serving engine.

One process serves many scenes, but packing a scene's weights into the
kernel layout (``kernel_weights``, RMCM included) is load-time work
the render path must never repeat (``kernels.ops.pack_count`` is the proof
obligation). ``SceneCache`` keeps a capacity-bounded LRU of
``PackedPlcore`` instances: the first touch of a scene pays the pack, and
every queued tile for a resident scene reuses it.

Capacity is in MB of the tensors a resident holds on its device (params +
RMCM quant tree + packed kernel layout): the quantity that competes for
device memory. A resident with tiles in flight on the executor is PINNED
(``pin``/``unpin`` refcounts): eviction skips pinned entries, so a scene
whose dispatched tiles have not drained can never lose its weights to a
colder scene's load. Eviction never removes the just-inserted entry, so a
cache smaller than one scene still serves (it thrashes, and the counters
show it).

Auxiliary residents (adaptive sampling's per-scene ``SceneAux``:
calibration stats + trunk memo, attached by ``ensure_aux``) count against
the same capacity at their LIVE size (the memo grows and evicts while
serving, so eviction re-reads ``aux.nbytes``) and leave with their scene.

The accounting is PER CELL: a replicated tensor costs its full size on
every cell (so it counts once), but a resident whose trunk stacks are
layer-sharded over a cell list (``PackedPlcore(..., shard_mesh=...)``)
costs each cell only its shard (``device_nbytes``), so the same
``capacity_mb`` holds about n_shards times more scenes. Under per-cell
dispatch a pin may also name the tile's home cell (``pinned_cells``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.pipeline import PackedPlcore
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.sharding import LayerShards


class SceneLoadError(RuntimeError):
    """``SceneCache.get`` failed to produce a resident scene: either the
    loader raised (``fail_fast=False`` — the original exception is
    chained) or the scene is in negative-result backoff after a recent
    failure (``fail_fast=True`` — the loader was NOT invoked)."""

    def __init__(self, msg: str, *, fail_fast: bool = False):
        super().__init__(msg)
        self.fail_fast = fail_fast


def device_nbytes(a) -> int:
    """Per-cell resident bytes of one array: the most any single cell
    holds. A tensor (replicated, or on one device) costs its full size; a
    trunk stack sharded k ways over a cell list about size / k."""
    if isinstance(a, LayerShards):
        return max(a.cell_nbytes(c) for c in range(len(a.mesh)))
    return a.numel() * a.element_size()


def tree_nbytes(tree) -> int:
    """Per-cell bytes of every array in a nested dict (``device_nbytes``;
    other leaves count 0)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (torch.Tensor, LayerShards)):
        return device_nbytes(tree)
    return 0


def plcore_nbytes(pp: PackedPlcore) -> int:
    """Per-cell resident bytes of one loaded scene: raw params + RMCM quant
    tree + packed kernel layout, sharded stacks at their per-cell size."""
    return tree_nbytes(pp.params) + tree_nbytes(pp.quant) \
        + tree_nbytes(pp.packed)


class SceneCache:
    """LRU cache of loaded scenes: ``scene_id -> PackedPlcore``.

    ``loader(scene_id)`` builds a PackedPlcore on a miss (the once-per-
    residency pack); ``capacity_mb`` bounds the total resident bytes.
    Hits, misses and evictions are counted for the serving stats.

    A loader that RAISES leaves the cache exactly as it was: no partial
    entry, no stale pin, and the failure counted (``load_failures``). The
    scene then enters attempt-based negative-result backoff: the next
    ``fail_backoff`` ``get`` calls for it raise
    ``SceneLoadError(fail_fast=True)`` WITHOUT invoking the loader,
    doubling per consecutive failure up to ``max_fail_backoff``; the first
    ``get`` after the backoff retries the loader, and a success clears
    the failure state."""

    #: Wired by the owning engine (instance attributes then): ``tracer``
    #: records the cache.* residency events, ``trace_host`` tags them with
    #: the owning cluster host. A bare SceneCache records nothing.
    tracer = NULL_TRACER
    trace_host = None

    def __init__(self, loader: Callable[[str], PackedPlcore],
                 capacity_mb: float = 256.0, *, fail_backoff: int = 4,
                 max_fail_backoff: int = 64):
        self._loader = loader
        self.capacity_bytes = int(capacity_mb * (1 << 20))
        self._entries: "OrderedDict[str, Tuple[PackedPlcore, int]]" = \
            OrderedDict()
        # scene -> auxiliary resident (sampling.SceneAux) riding the entry
        self._aux: Dict[str, object] = {}
        self._pins: Dict[str, int] = {}
        # per-cell pins (per-cell dispatch): scene -> cell -> refcount, a
        # sub-account of _pins; eviction still gates on the total
        self._cell_pins: Dict[str, Dict[int, int]] = {}
        self.fail_backoff = int(fail_backoff)
        self.max_fail_backoff = int(max_fail_backoff)
        # scene -> [consecutive real failures, fail-fast credits left]
        self._failed: Dict[str, list] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.load_failures = 0      # loader raised
        self.fail_fasts = 0         # negative-result backoff short-circuits

    def __contains__(self, scene_id: str) -> bool:
        return scene_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def resident_scenes(self) -> list:
        """LRU -> MRU order."""
        return list(self._entries)

    @property
    def aux_bytes(self) -> int:
        """LIVE auxiliary resident bytes, re-read on every call (the memo
        grows and evicts while serving)."""
        return sum(a.nbytes for a in self._aux.values())

    @property
    def resident_bytes(self) -> int:
        return (sum(nb for _, nb in self._entries.values())
                + self.aux_bytes)

    def aux(self, scene_id: str):
        """The scene's auxiliary resident, or None (never built, or dropped
        with an eviction)."""
        return self._aux.get(scene_id)

    def ensure_aux(self, scene_id: str, builder) -> object:
        """Attach (or fetch) the scene's auxiliary resident.
        ``builder(pp)`` runs once per residency (the adaptive probe,
        ``pipeline.build_scene_aux``); its product counts against the
        capacity at its live size, leaves when the scene is evicted and is
        protected by the scene's pins. The scene must be resident (``get``
        it first): aux without weights has nothing to serve."""
        aux = self._aux.get(scene_id)
        if aux is not None:
            return aux
        ent = self._entries.get(scene_id)
        if ent is None:
            raise KeyError(f"scene {scene_id!r} is not resident — "
                           "load it before attaching aux")
        tr = self.tracer
        sp = tr.begin("cache.aux_build", cat="cache", scene=scene_id,
                      host=self.trace_host) if tr.enabled else None
        aux = builder(ent[0])
        self._aux[scene_id] = aux
        tr.end(sp, ok=True, bytes=int(aux.nbytes))
        self._evict_over_capacity(keep=scene_id)
        return aux

    def pin(self, scene_id: str, cell: Optional[int] = None) -> None:
        """Refcount one in-flight use of a resident scene: a pinned entry
        is skipped by eviction until its last ``unpin`` (the executor pins
        at tile dispatch and unpins when the tile's scatter drains).
        ``cell`` (per-cell dispatch) also books the pin to the tile's home
        cell (``pinned_cells``); eviction still gates on the total."""
        self._pins[scene_id] = self._pins.get(scene_id, 0) + 1
        if cell is not None:
            by_cell = self._cell_pins.setdefault(scene_id, {})
            by_cell[int(cell)] = by_cell.get(int(cell), 0) + 1
        if self.tracer.enabled:
            self.tracer.event("cache.pin", cat="cache", scene=scene_id,
                              host=self.trace_host, cell=cell,
                              refs=self._pins[scene_id])

    def unpin(self, scene_id: str, cell: Optional[int] = None) -> None:
        n = self._pins.get(scene_id, 0) - 1
        if n <= 0:
            self._pins.pop(scene_id, None)
        else:
            self._pins[scene_id] = n
        if cell is not None:
            by_cell = self._cell_pins.get(scene_id)
            if by_cell is not None:
                c = by_cell.get(int(cell), 0) - 1
                if c <= 0:
                    by_cell.pop(int(cell), None)
                else:
                    by_cell[int(cell)] = c
                if not by_cell:
                    self._cell_pins.pop(scene_id, None)
        if self.tracer.enabled:
            self.tracer.event("cache.unpin", cat="cache", scene=scene_id,
                              host=self.trace_host, cell=cell,
                              refs=max(0, n))

    def pinned(self, scene_id: str) -> bool:
        return scene_id in self._pins

    def pinned_cells(self, scene_id: str) -> dict:
        """cell -> in-flight pin refcount of one scene (empty when none of
        its per-cell tiles is in flight)."""
        return dict(self._cell_pins.get(scene_id, {}))

    def discard(self, scene_id: str) -> bool:
        """Drop one resident entry (and its aux) outside the LRU policy.
        A pinned entry is refused: weights under an in-flight tile never
        go. Returns whether an entry was dropped."""
        if scene_id not in self._entries or scene_id in self._pins:
            return False
        del self._entries[scene_id]
        self._aux.pop(scene_id, None)
        self.evictions += 1
        if self.tracer.enabled:
            self.tracer.event("cache.evict", cat="cache", scene=scene_id,
                              host=self.trace_host, reason="discard")
        return True

    def _evict_over_capacity(self, keep: str) -> None:
        """Evict LRU-first until the LIVE resident total (weights + aux)
        fits capacity. ``keep`` (the just-touched scene) and pinned entries
        are never victims; an evicted scene's aux goes with it."""
        for victim in list(self._entries):   # LRU -> MRU order
            if (len(self._entries) <= 1
                    or self.resident_bytes <= self.capacity_bytes):
                break
            if victim == keep or victim in self._pins:
                continue
            del self._entries[victim]
            self._aux.pop(victim, None)
            self.evictions += 1
            if self.tracer.enabled:
                self.tracer.event("cache.evict", cat="cache", scene=victim,
                                  host=self.trace_host, reason="capacity")

    def failing_scenes(self) -> list:
        """Scenes in load-failure state (at least one consecutive real
        loader failure, the backoff window possibly still open)."""
        return list(self._failed)

    def get(self, scene_id: str) -> PackedPlcore:
        """Fetch a scene, loading (and possibly evicting) on a miss.
        Pinned entries and the just-inserted entry are never eviction
        victims: a cache whose unpinned residents don't cover the overflow
        stays over capacity until pins drain."""
        tr = self.tracer
        ent = self._entries.get(scene_id)
        if ent is not None:
            self.hits += 1
            self._entries.move_to_end(scene_id)
            if tr.enabled:
                tr.event("cache.hit", cat="cache", scene=scene_id,
                         host=self.trace_host)
            return ent[0]
        fail = self._failed.get(scene_id)
        if fail is not None and fail[1] > 0:
            fail[1] -= 1
            self.fail_fasts += 1
            if tr.enabled:
                tr.event("cache.load_backoff", cat="cache", scene=scene_id,
                         host=self.trace_host, failures=fail[0],
                         credits_left=fail[1])
            raise SceneLoadError(
                f"scene {scene_id!r} is in load-failure backoff "
                f"({fail[0]} consecutive failures; retry in {fail[1] + 1} "
                f"more attempts)", fail_fast=True)
        self.misses += 1
        sp = tr.begin("cache.load", cat="cache", scene=scene_id,
                      host=self.trace_host) if tr.enabled else None
        try:
            pp = self._loader(scene_id)
            nbytes = plcore_nbytes(pp)
        except Exception as e:
            # nothing was inserted (the entry only lands below, after the
            # loader AND the size accounting succeed): count the failure
            # and arm the fail-fast window
            self.load_failures += 1
            n_fail = (fail[0] if fail else 0) + 1
            self._failed[scene_id] = [
                n_fail, min(self.fail_backoff * (2 ** (n_fail - 1)),
                            self.max_fail_backoff)]
            tr.end(sp, ok=False, error=str(e)[:120])
            raise SceneLoadError(
                f"loader failed for scene {scene_id!r}: {e}") from e
        tr.end(sp, ok=True, bytes=nbytes)
        self._failed.pop(scene_id, None)
        self._entries[scene_id] = (pp, nbytes)
        self._evict_over_capacity(keep=scene_id)
        return pp

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "resident_scenes": len(self._entries),
            "pinned_scenes": len(self._pins),
            "aux_scenes": len(self._aux),
            "aux_mb": round(self.aux_bytes / (1 << 20), 3),
            "resident_mb": round(self.resident_bytes / (1 << 20), 3),
            "capacity_mb": round(self.capacity_bytes / (1 << 20), 3),
            "load_failures": self.load_failures,
            "fail_fasts": self.fail_fasts,
            "failing_scenes": len(self._failed),
        }

    def consecutive_failures(self, scene_id: str) -> int:
        """Consecutive real loader failures for a scene (0 when healthy);
        the scheduler reads it to decide when a scene is dead."""
        fail = self._failed.get(scene_id)
        return fail[0] if fail else 0
