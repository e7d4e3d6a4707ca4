"""Bounded ring-buffer span tracer for the serving engine.

Every request and every tile walks a fixed lifecycle through the
scheduler / executor / completion layers (engine module docstring); the
tracer records that walk as SPANS (named intervals with attributes) and
INSTANT events in one bounded ring. Design constraints, in order:

* **Deterministic.** Span ids are a per-tracer sequence counter, and
  every timestamp comes from the tracer's injectable ``clock`` — the
  same fake clock the engine runs on. Fixed seed + fake clock => two
  runs produce identical span streams (a CI-checkable property, like
  the engine's bit-identity gates).
* **Bounded.** The ring holds ``capacity`` closed spans; overflow drops
  the OLDEST and counts ``dropped`` — a long-running server can leave
  tracing on without unbounded memory, and exporters can say exactly
  how much history they are missing.
* **Cheap when off.** ``NULL_TRACER`` no-ops every call; instrumented
  code tests ``tracer.enabled`` only where it would otherwise do real
  work (building attribute dicts).
* **On the profiler's clock.** ``range`` records a span over a block of
  code and holds a ``torch.profiler.record_function`` of the same name
  open around it, so a device trace taken meanwhile shows the engine's
  layers where they ran (the engine's ranges: ``engine.submit``,
  ``scheduler.next_tile``, ``plcore.dispatch``, ``executor.drain``,
  ``completion.scatter``).

Span taxonomy: ``request.*`` lifecycle, ``tile.*`` per-dispatch chain
(coalesce -> dispatch -> device_compute -> drain -> scatter, with retry /
fallback / redispatch branches), ``cache.*`` residency; on the card,
``tile.kernel`` (category ``device``), a tile's interval on the device
from its CUDA events.

A copy of the reference package's ``obs.trace``; the port imports nothing
of the reference.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Dict, List, Optional

import torch

__all__ = ["Span", "SpanTracer", "NullTracer", "NULL_TRACER"]


class Span:
    """One named interval (``ph="X"``) or instant (``ph="i"``).
    ``t1 is None`` while the span is open. ``attrs`` is flat
    (str -> scalar); exporters pass it through as Chrome ``args``."""
    __slots__ = ("sid", "name", "cat", "ph", "t0", "t1", "attrs")

    def __init__(self, sid: int, name: str, cat: str, ph: str,
                 t0: float, t1: Optional[float], attrs: dict):
        self.sid = sid
        self.name = name
        self.cat = cat
        self.ph = ph
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs

    def key(self) -> tuple:
        """Deterministic identity for replay comparison: everything,
        attributes sorted."""
        return (self.sid, self.name, self.cat, self.ph, self.t0, self.t1,
                tuple(sorted(self.attrs.items())))

    def __repr__(self):
        dur = ("open" if self.t1 is None
               else f"{(self.t1 - self.t0) * 1e6:.1f}us")
        return f"<Span {self.sid} {self.name} [{self.cat}] {dur} {self.attrs}>"


class NullTracer:
    """The tracing-off fast path: every method is a no-op returning a
    harmless value. Instrumented code never branches on ``None`` —
    it calls through unconditionally."""
    enabled = False

    def begin(self, name, cat="engine", **attrs):
        return None

    def end(self, span, **attrs):
        pass

    def event(self, name, cat="engine", **attrs):
        return None

    def complete(self, name, t0, cat="engine", t1=None, **attrs):
        return None

    def range(self, name, cat="engine", **attrs):
        return _NULL_RANGE

    def sampled_request(self, rid: int) -> bool:
        return False

    def spans(self):
        return []

    def summary(self) -> dict:
        return {"enabled": False}


NULL_TRACER = NullTracer()
_NULL_RANGE = contextlib.nullcontext()


class SpanTracer:
    """The real tracer. ``capacity`` bounds CLOSED spans (open spans are
    held separately until ended); ``sample_every=N`` samples request
    lifecycle chains (rid % N == 0) while tile/cache/host events stay
    always-on — the span-chain integrity gate covers 100% of dispatched
    tiles regardless of request sampling."""
    enabled = True

    def __init__(self, capacity: int = 65536, clock=time.perf_counter,
                 sample_every: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.capacity = int(capacity)
        self.clock = clock
        self.sample_every = int(sample_every)
        self._ring: deque = deque(maxlen=self.capacity)
        self._open: Dict[int, Span] = {}
        self._sid = 0
        self.dropped = 0

    # ------------------------------------------------------------ emit ----
    def _next_sid(self) -> int:
        sid = self._sid
        self._sid += 1
        return sid

    def _commit(self, span: Span) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(span)

    def begin(self, name: str, cat: str = "engine", **attrs) -> Span:
        """Open a span; close it with ``end``. Open spans don't occupy
        ring capacity and survive overflow."""
        span = Span(self._next_sid(), name, cat, "X", self.clock(), None,
                    attrs)
        self._open[span.sid] = span
        return span

    def end(self, span: Optional[Span], **attrs) -> None:
        """Close an open span (no-op for ``None`` — the sampled-out /
        NullTracer handle), folding in final attributes."""
        if span is None:
            return
        span.t1 = self.clock()
        if attrs:
            span.attrs.update(attrs)
        self._open.pop(span.sid, None)
        self._commit(span)

    def event(self, name: str, cat: str = "engine", **attrs) -> Span:
        """Instant event (zero-duration mark)."""
        now = self.clock()
        span = Span(self._next_sid(), name, cat, "i", now, now, attrs)
        self._commit(span)
        return span

    def complete(self, name: str, t0: float, cat: str = "engine",
                 t1: Optional[float] = None, **attrs) -> Span:
        """Retrofit span: the caller measured ``t0`` itself (no handle
        to thread through); the end is ``t1`` on the tracer's clock, or
        now."""
        span = Span(self._next_sid(), name, cat, "X", t0,
                    self.clock() if t1 is None else t1, attrs)
        self._commit(span)
        return span

    @contextlib.contextmanager
    def range(self, name: str, cat: str = "engine", **attrs):
        """A span over the ``with`` block, on the tracer's clock, inside a
        profiler range of the same name. Yields the span's attribute dict,
        which the block may add to; the span is committed when the block
        exits, as ``complete`` commits one."""
        with torch.profiler.record_function(name):
            t0 = self.clock()
            try:
                yield attrs
            finally:
                self._commit(Span(self._next_sid(), name, cat, "X", t0,
                                  self.clock(), attrs))

    # ------------------------------------------------------------ read ----
    def sampled_request(self, rid: int) -> bool:
        return self.sample_every <= 1 or rid % self.sample_every == 0

    def spans(self) -> List[Span]:
        """Closed spans, oldest first (newest ``capacity`` survive)."""
        return list(self._ring)

    def open_spans(self) -> List[Span]:
        return list(self._open.values())

    def summary(self) -> dict:
        spans = events = 0
        for s in self._ring:
            if s.ph == "i":
                events += 1
            else:
                spans += 1
        return {
            "spans": spans,
            "events": events,
            "open_spans": len(self._open),
            "dropped": self.dropped,
            "capacity": self.capacity,
            "sample_every": self.sample_every,
        }
