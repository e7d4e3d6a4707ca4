"""Exporters + trace-integrity validation for the port's observability
layer (a copy of the reference package's ``obs.export``; the port imports
nothing of the reference).

Three artifact shapes:

* ``chrome_trace`` — Chrome trace-event JSON (the ``traceEvents`` array
  format), loadable in Perfetto / ``chrome://tracing``. One *process*
  track per host, one *thread* track per executor slot (device-compute
  spans), per device (``tile.kernel``: a tile's interval on the card,
  category ``device``) or per span category, with metadata name events
  so the UI labels them. Timestamps are microseconds relative to the earliest
  span, durations from the tracer's own clock.
* ``prometheus_text`` — the text exposition format (``# HELP`` /
  ``# TYPE``, cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``
  for histograms). Merges any number of registries (per-engine + the
  process-global kernel counters).
* ``snapshot`` — a plain-JSON dump of every metric for programmatic
  diffing (the benchmarks block persists a subset of this).

``validate_trace`` is the integrity gate behind ``serve.py --check``:
every tile that was ever dispatched must reach exactly one terminal
(scatter or drop) through a legal state walk, and every traced request
submit must map to exactly one terminal request span. It operates on
the span stream — ``validate_chrome_trace`` re-runs the same check on
an exported JSON file (the CI artifact check), so a schema drift
between exporter and validator cannot pass silently.

``device_busy`` reads the card's busy share from the ``tile.kernel``
spans (the port's addition; the validator ignores their name).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Span, SpanTracer

__all__ = ["chrome_trace", "write_chrome_trace", "prometheus_text",
           "snapshot", "validate_trace", "validate_chrome_trace",
           "device_busy"]

# Thread-track ids per span category (device-compute spans use
# 10 + slot instead, one track per executor slot; a tile's interval on
# the card, category "device", 100 + device index, one track per device).
_CAT_TIDS = {"request": 1, "tile": 2, "cache": 3, "host": 4, "plcore": 5}
_SLOT_TID0 = 10
_DEVICE_TID0 = 100


def _tid(span_attrs: dict, cat: str) -> int:
    if cat == "device":
        return _DEVICE_TID0 + int(span_attrs.get("device") or 0)
    slot = span_attrs.get("slot")
    if slot is not None:
        return _SLOT_TID0 + int(slot)
    return _CAT_TIDS.get(cat, 9)


def _track_label(span_attrs: dict, cat: str) -> str:
    if cat == "device":
        return f"device {int(span_attrs.get('device') or 0)}"
    slot = span_attrs.get("slot")
    return f"slot {slot}" if slot is not None else cat


def chrome_trace(tracer_or_spans) -> dict:
    """Spans -> Chrome trace-event JSON object. Open spans are exported
    too (as zero-duration marks at their start) so a crashed run's
    half-finished work is still visible."""
    if isinstance(tracer_or_spans, SpanTracer):
        spans = tracer_or_spans.spans() + tracer_or_spans.open_spans()
    else:
        spans = list(tracer_or_spans)
    t_min = min((s.t0 for s in spans), default=0.0)
    events = []
    tracks = {}      # (pid, tid) -> label
    for s in spans:
        pid = int(s.attrs.get("host") or 0)
        tid = _tid(s.attrs, s.cat)
        if (pid, tid) not in tracks:
            tracks[(pid, tid)] = _track_label(s.attrs, s.cat)
        ev = {
            "name": s.name,
            "cat": s.cat,
            "ph": "i" if s.ph == "i" else "X",
            "ts": round((s.t0 - t_min) * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": {k: v for k, v in s.attrs.items()},
        }
        if s.ph == "i":
            ev["s"] = "t"                      # instant scope: thread
        else:
            t1 = s.t1 if s.t1 is not None else s.t0
            ev["dur"] = round((t1 - s.t0) * 1e6, 3)
        events.append(ev)
    meta = []
    for pid in sorted({p for p, _ in tracks}):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": f"host {pid}"}})
    for (pid, tid), label in sorted(tracks.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": label}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer_or_spans, path: str) -> dict:
    obj = chrome_trace(tracer_or_spans)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


# ---------------------------------------------------------------------------
def _label_str(label_key) -> str:
    if not label_key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in label_key) + "}"


def prometheus_text(*registries: MetricsRegistry) -> str:
    """Prometheus text exposition over one or more registries (merged in
    order). Gauges still at their ``None`` init are skipped — "never
    observed" must not export as 0."""
    lines: List[str] = []
    seen = set()
    for reg in registries:
        for fam in reg.families():
            if fam.name in seen:
                continue
            seen.add(fam.name)
            lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for label_key, child in fam.children():
                ls = _label_str(label_key)
                if fam.kind == "histogram":
                    cum = child.cumulative()
                    bounds = list(child.bounds) + ["+Inf"]
                    for b, c in zip(bounds, cum):
                        le = b if b == "+Inf" else repr(float(b))
                        sep = "," if label_key else ""
                        inner = (ls[1:-1] + sep if label_key else "")
                        lines.append(f'{fam.name}_bucket{{{inner}le="{le}"}}'
                                     f" {c}")
                    lines.append(f"{fam.name}_sum{ls} {child.sum}")
                    lines.append(f"{fam.name}_count{ls} {child.count}")
                else:
                    if child.value is None:
                        continue
                    lines.append(f"{fam.name}{ls} {child.value}")
    return "\n".join(lines) + "\n"


def snapshot(*registries: MetricsRegistry) -> dict:
    """Plain-JSON metric dump: name -> {kind, help, series: [{labels,
    value | (sum, count, buckets)}]}."""
    out: Dict[str, dict] = {}
    for reg in registries:
        for fam in reg.families():
            if fam.name in out:
                continue
            series = []
            for label_key, child in fam.children():
                entry = {"labels": dict(label_key)}
                if fam.kind == "histogram":
                    entry.update(sum=child.sum, count=child.count,
                                 bounds=list(child.bounds),
                                 buckets=list(child.counts))
                else:
                    entry["value"] = child.value
                series.append(entry)
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
    return out


# ---------------------------------------------------------------------------
# Trace-integrity validation: the per-tile lifecycle state machine. A
# tile id seen in ANY tile.* record must finish in a terminal state.
_TILE_TRANSITIONS = {
    "tile.dispatch": "in_flight",
    "tile.drain": "drained",
    "tile.abandon": "requeued",
    "tile.requeue": "requeued",
    "tile.scatter": "done",
    "tile.drop": "dropped",
}
_TERMINAL_TILE_STATES = ("done", "dropped")


def _records(tracer_or_spans):
    if isinstance(tracer_or_spans, SpanTracer):
        return list(tracer_or_spans.spans()), tracer_or_spans.dropped
    return list(tracer_or_spans), 0


def validate_trace(tracer_or_spans) -> dict:
    """Span-chain integrity over a span stream (or tracer). Checks:

    * ring overflow dropped nothing (a partial stream can't be proven);
    * every tile id walks a legal lifecycle and ends terminal — a
      ``tile.dispatch`` with no eventual ``tile.scatter``/``tile.drop``
      is an ORPHAN (lost pixels), a post-terminal dispatch is a
      double-serve;
    * every traced ``request.submit`` has exactly one terminal
      ``request.complete`` and one closed ``request`` lifecycle span.

    Returns ``{"ok", "errors", "tiles", "dispatched_tiles",
    "requests"}`` with at most 20 errors listed."""
    spans, dropped = _records(tracer_or_spans)
    errors: List[str] = []
    if dropped:
        errors.append(f"ring buffer dropped {dropped} spans — raise "
                      f"capacity to validate this run")
    tile_state: Dict[int, str] = {}
    tile_dispatched: Dict[int, bool] = {}
    req: Dict[int, List[int]] = {}     # rid -> [submits, terminals, spans]
    for s in sorted(spans, key=lambda s: s.sid):
        if s.cat == "tile" and "tile" in s.attrs:
            nxt = _TILE_TRANSITIONS.get(s.name)
            if nxt is None:
                continue
            tid = s.attrs["tile"]
            cur = tile_state.get(tid)
            if cur in _TERMINAL_TILE_STATES and nxt == "in_flight":
                errors.append(f"tile {tid}: dispatched again after "
                              f"terminal state {cur!r}")
            tile_state[tid] = nxt
            if s.name == "tile.dispatch":
                tile_dispatched[tid] = True
        elif s.cat == "request" and "request" in s.attrs:
            rec = req.setdefault(s.attrs["request"], [0, 0, 0])
            if s.name == "request.submit":
                rec[0] += 1
            elif s.name == "request.complete":
                rec[1] += 1
            elif s.name == "request" and s.ph == "X" and s.t1 is not None:
                rec[2] += 1
    for tid, state in tile_state.items():
        if state not in _TERMINAL_TILE_STATES:
            errors.append(f"tile {tid}: non-terminal final state "
                          f"{state!r} (orphan chain)")
    for rid, (n_sub, n_term, n_span) in req.items():
        if n_sub != 1 or n_term != 1 or n_span != 1:
            errors.append(f"request {rid}: submits={n_sub} "
                          f"terminals={n_term} lifecycle_spans={n_span} "
                          f"(want exactly 1 each)")
    return {
        "ok": not errors,
        "errors": errors[:20],
        "tiles": len(tile_state),
        "dispatched_tiles": sum(tile_dispatched.values()),
        "requests": len(req),
    }


def validate_chrome_trace(obj: dict) -> dict:
    """Schema + chain check on an exported Chrome trace JSON object (the
    CI artifact gate). Verifies required event fields, then replays
    ``validate_trace`` over spans reconstructed from the ``args``."""
    errors: List[str] = []
    events = obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        return {"ok": False, "errors": ["traceEvents missing or empty"],
                "events": 0}
    spans: List[Span] = []
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            if "name" not in ev or "args" not in ev:
                errors.append(f"event {i}: metadata without name/args")
            continue
        for field in ("name", "cat", "ts", "pid", "tid"):
            if field not in ev:
                errors.append(f"event {i}: missing {field!r}")
        if ph == "X" and "dur" not in ev:
            errors.append(f"event {i}: complete event without dur")
        if ph not in ("X", "i"):
            errors.append(f"event {i}: unexpected phase {ph!r}")
        if errors:
            continue
        t0 = ev["ts"] * 1e-6
        t1 = t0 + (ev.get("dur", 0.0) * 1e-6 if ph == "X" else 0.0)
        spans.append(Span(i, ev["name"], ev["cat"], ph, t0, t1,
                          dict(ev.get("args", {}))))
    if errors:
        return {"ok": False, "errors": errors[:20], "events": len(events)}
    out = validate_trace(spans)
    out["events"] = len(events)
    return out


def device_busy(tracer_or_spans) -> dict:
    """The card's busy share over a trace: the union of its ``tile.kernel``
    spans (each tile's interval on the device, from CUDA events) over the
    traced window (the earliest span start to the latest span end).
    ``busy_share`` is None when the trace holds no device span (a CPU
    run)."""
    spans, _ = _records(tracer_or_spans)
    kern = sorted((s.t0, s.t1) for s in spans
                  if s.name == "tile.kernel" and s.t1 is not None)
    ends = [s.t1 for s in spans if s.t1 is not None]
    window = (max(ends) - min(s.t0 for s in spans)) if spans else 0.0
    busy, cur = 0.0, None
    for t0, t1 in kern:
        if cur is None or t0 > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [t0, t1]
        else:
            cur[1] = max(cur[1], t1)
    if cur is not None:
        busy += cur[1] - cur[0]
    return {"kernel_spans": len(kern), "busy_s": busy, "window_s": window,
            "busy_share": (busy / window if kern and window > 0 else None)}
