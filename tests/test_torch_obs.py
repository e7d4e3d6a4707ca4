"""The port's copies of the reference's observability and straggler
modules, against the reference's on the same inputs, and the tracer on the
port's engine: its spans, its layer ranges under ``torch.profiler`` and
the trace block of its stats."""
import json

import numpy as np
import pytest
import torch

from repro.runtime.straggler import StragglerConfig as JaxStragglerConfig
from repro.runtime.straggler import StragglerMonitor as JaxStragglerMonitor

from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.core.plcore import plcore_decls
from repro_torch.models.params import init_params
from repro_torch.obs.metrics import (ENGINE_STATS_SCHEMA, K2_MIP_ROW_STATS,
                                     K2_PHASES, K2_ROW_COUNTS, K2_ROW_STATS,
                                     TRACE_STATS_SCHEMA, MetricsRegistry,
                                     engine_stats_view, log_buckets)
from repro_torch.obs.trace import NULL_TRACER, SpanTracer
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor
from repro_torch.serving import RenderEngine, RenderRequest, SceneCache


def test_stats_view_writes_through_to_the_registry():
    reg = MetricsRegistry()
    st = engine_stats_view(reg)
    assert list(st) == [k for k, *_ in ENGINE_STATS_SCHEMA]
    st["dispatches"] += 3
    st["status_counts"]["ok"] = 2
    st.update(max_in_flight=4)
    assert reg.get("engine_dispatches_total").value == 3
    assert reg.get("engine_max_in_flight").value == 4
    fam = reg.get("engine_requests_by_status_total")
    assert fam.labels(status="ok").value == 2
    assert dict(st)["status_counts"] == {"ok": 2}
    st.m.service_seconds.observe(2e-3)
    hist = reg.get("engine_tile_service_seconds").default
    assert hist.count == 1 and hist.cumulative()[-1] == 1
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("engine_dispatches_total")
    assert log_buckets(1e-3, 1.0, 1) == (1e-3, 1e-2, 1e-1, 1.0)


def test_span_tracer_is_bounded_and_deterministic():
    def run():
        t = iter(range(100))
        tr = SpanTracer(capacity=3, clock=lambda: float(next(t)))
        sp = tr.begin("tile.device_compute", cat="tile", tile=0)
        for i in range(4):
            tr.event("cache.hit", cat="cache", scene=f"s{i}")
        tr.end(sp, slot=1)
        return tr
    a, b = run(), run()
    assert [s.key() for s in a.spans()] == [s.key() for s in b.spans()]
    assert len(a.spans()) == 3 and a.dropped == 2
    assert a.spans()[-1].name == "tile.device_compute"
    assert a.summary()["open_spans"] == 0
    assert NULL_TRACER.begin("x") is None and not NULL_TRACER.enabled


def test_straggler_monitor_matches_reference():
    rng = np.random.RandomState(0)
    steps = list(rng.uniform(0.01, 0.02, 30)) + [0.5, 0.015, 0.9]
    cfg = dict(warmup_steps=3, deadline_factor=3.0, ewma_alpha=0.1)
    ours = StragglerMonitor(StragglerConfig(**cfg))
    ref = JaxStragglerMonitor(JaxStragglerConfig(**cfg))
    for i, d in enumerate(steps):
        per_host = {0: d, 1: 2.0 * d} if i % 2 else None
        assert ours.record_step(d, per_host) == ref.record_step(d, per_host)
    assert ours.summary() == ref.summary()
    assert ours.summary()["events"]      # the two stalls were caught


def test_engine_traces_every_tile_to_its_scatter():
    cfg = tiny()
    params = init_params(plcore_decls(cfg), torch.Generator().manual_seed(0))
    tr = SpanTracer()
    eng = RenderEngine(
        SceneCache(lambda sid: PackedPlcore(cfg, params, device="cpu",
                                            use_kernel=True,
                                            fuse_two_pass=True)),
        tile_rays=64, pipeline_depth=2, tracer=tr)
    for hw in (8, 12):
        eng.submit(RenderRequest("s0", hw=hw))
    eng.drain()
    names = [s.name for s in tr.spans()]
    n = eng.stats["dispatches"]
    for name in ("tile.coalesce", "tile.dispatch", "tile.device_compute",
                 "tile.drain", "tile.scatter"):
        assert names.count(name) == n, name
    assert names.count("request") == 2 and names.count("cache.load") == 1
    assert tr.summary()["open_spans"] == 0


# ------------------------------------------------------------ layer ranges --
RANGES = ("engine.submit", "scheduler.next_tile", "plcore.dispatch",
          "executor.drain", "completion.scatter")


def _engine(tracer=None, clock=None, **kw):
    cfg = tiny()
    params = init_params(plcore_decls(cfg), torch.Generator().manual_seed(0))
    extra = {} if clock is None else {"clock": clock}
    return RenderEngine(
        SceneCache(lambda sid: PackedPlcore(cfg, params, device="cpu",
                                            use_kernel=True,
                                            fuse_two_pass=True)),
        tile_rays=64, pipeline_depth=2, tracer=tracer, **extra, **kw)


def _profiled(eng, tmp_path):
    """Two views through ``eng`` under the CPU profiler; the exported
    trace's events named as the engine's ranges."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for hw in (8, 12):
            eng.submit(RenderRequest("s0", hw=hw))
        eng.drain()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("name") in RANGES]


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_traced_engine_opens_its_layer_ranges_in_the_profiler(tmp_path):
    """A traced engine's five layer ranges reach the profiler's trace, one
    per call, nested as the calls nest (every scatter inside a drain; a
    submit and a tile's coalescing inside nothing else of the engine), and
    each is a span of the tracer too."""
    tr = SpanTracer()
    eng = _engine(tr)
    evs = _profiled(eng, tmp_path)
    n = eng.stats["dispatches"]
    count = {name: sum(e["name"] == name for e in evs) for name in RANGES}
    assert count == {"engine.submit": 2, "scheduler.next_tile": n + 1,
                     "plcore.dispatch": n, "executor.drain": n,
                     "completion.scatter": n}, count
    spans = [s.name for s in tr.spans()]
    assert {name: spans.count(name) for name in RANGES} == count
    drains = [e for e in evs if e["name"] == "executor.drain"]
    for e in evs:
        inside = {o["name"] for o in evs if o is not e and _inside(e, o)}
        if e["name"] == "completion.scatter":
            assert inside == {"executor.drain"}, inside
        else:
            assert not inside, (e["name"], inside)
    assert all(any(_inside(e, d) for d in drains)
               for e in evs if e["name"] == "completion.scatter")
    # the tracer's own range spans nest alike: each scatter's interval
    # lies inside one drain's
    sp = tr.spans()
    for s in (s for s in sp if s.name == "completion.scatter"):
        assert any(d.t0 <= s.t0 and s.t1 <= d.t1 for d in sp
                   if d.name == "executor.drain")


def test_untraced_engine_opens_no_range_and_keeps_its_keys(tmp_path):
    eng = _engine(NULL_TRACER)
    assert _profiled(eng, tmp_path) == []
    assert list(dict(eng.stats)) == [k for k, *_ in ENGINE_STATS_SCHEMA]
    traced = _engine(SpanTracer())
    assert list(dict(traced.stats)) == [
        k for k, *_ in ENGINE_STATS_SCHEMA + TRACE_STATS_SCHEMA]
    with NULL_TRACER.range("x", "engine", a=1) as attrs:
        assert attrs is None


def test_span_tracer_range_is_a_span_on_its_clock():
    t = iter(range(10))
    tr = SpanTracer(clock=lambda: float(next(t)))
    with tr.range("plcore.dispatch", "plcore", rays=4) as attrs:
        attrs.update(cell=-1)
        tr.event("inner")
    inner, outer = tr.spans()
    assert (outer.name, outer.cat, outer.ph) == ("plcore.dispatch", "plcore",
                                                 "X")
    assert (outer.t0, inner.t0, outer.t1) == (0.0, 1.0, 2.0)
    assert outer.attrs == {"rays": 4, "cell": -1}
    assert outer.sid > inner.sid     # committed on exit, as complete does


class _StepClock:
    def __init__(self, step=1e-3):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def test_trace_block_counts_on_a_fake_clock():
    """``admitted_views`` and ``backlog_tiles_at_admit`` take what the
    queue holds at each admitted submit (rays left over the 64-ray tile,
    rounded up, plus the tiles in flight; a rejected submit counts
    nothing), and ``host_wait_s`` one clock step per drain: on the fake
    clock nothing else reads the clock while the drain waits. On the CPU
    K2's phase and row counters stay 0."""
    clock = _StepClock()
    eng = _engine(SpanTracer(clock=clock), clock=clock, max_queue=4)
    st = eng.stats
    eng.submit(RenderRequest("s0", hw=8))      # 64 rays; ahead: nothing
    eng.submit(RenderRequest("s0", hw=12))     # 144; ahead: 64 rays = 1
    eng.submit(RenderRequest("s0", hw=8))      # ahead: 208 rays = 4 tiles
    assert (st["admitted_views"], st["backlog_tiles_at_admit"]) == (3, 5)
    assert eng.step() and eng.in_flight_tiles == 1
    eng.submit(RenderRequest("s0", hw=8))      # ahead: 4 tiles + 1 flying
    assert (st["admitted_views"], st["backlog_tiles_at_admit"]) == (4, 10)
    rid = eng.submit(RenderRequest("s0", hw=8))    # queue full: rejected
    assert eng.completed[rid].status == "rejected"
    assert (st["admitted_views"], st["backlog_tiles_at_admit"]) == (4, 10)
    eng.drain()
    assert st["host_wait_s"] == pytest.approx(st["dispatches"] * clock.step)
    assert all(st[f"plcore_two_pass_cycles_{p}"] == 0 for p in K2_PHASES)
    assert all(st[k] == 0 for k in K2_ROW_STATS)


def test_trace_block_holds_k2s_row_in_its_order():
    """K2's pinned row is its phase cycles, then the MMA rows and the real
    rows among them, then the k steps and those issued with the previous
    one in flight; Mip-NeRF's row adds the encoding's cycles after them.
    Each slot has its counter in the trace block, and a traced drain adds
    a tile's summed row slot by slot."""
    keys = [k for k, *_ in TRACE_STATS_SCHEMA]
    assert K2_ROW_COUNTS == ("rows_mma", "rows_real", "steps_mma",
                             "steps_overlapped")
    assert list(K2_ROW_STATS) == (
        [f"plcore_two_pass_cycles_{p}" for p in K2_PHASES]
        + ["plcore_two_pass_rows_mma", "plcore_two_pass_rows_real",
           "plcore_two_pass_steps_mma", "plcore_two_pass_steps_overlapped"])
    assert keys[:len(K2_ROW_STATS)] == list(K2_ROW_STATS)
    assert K2_MIP_ROW_STATS == K2_ROW_STATS + (
        "plcore_two_pass_cycles_encode",)
    assert keys[:len(K2_MIP_ROW_STATS)] == list(K2_MIP_ROW_STATS)

    class Handle:
        def __init__(self, row):
            self.row = row

        def phase_cycles(self):
            return self.row

    eng = _engine(SpanTracer())
    for _ in range(2):
        eng.executor._note_wait(
            Handle([70, 10, 5, 10, 100, 384, 256, 912, 846]), 0.25)
    st = eng.stats
    assert st["host_wait_s"] == pytest.approx(0.5)
    assert (st["plcore_two_pass_cycles_mlp"],
            st["plcore_two_pass_cycles_total"]) == (140, 200)
    assert (st["plcore_two_pass_rows_mma"],
            st["plcore_two_pass_rows_real"]) == (768, 512)
    assert (st["plcore_two_pass_steps_mma"],
            st["plcore_two_pass_steps_overlapped"]) == (1824, 1692)
    assert st["plcore_two_pass_cycles_encode"] == 0
    # a Mip-NeRF row: the encoding's cycles in the slot after the counts
    eng.executor._note_wait(
        Handle([70, 10, 5, 10, 100, 384, 384, 1824, 0, 3]), 0.25)
    assert (st["plcore_two_pass_steps_mma"],
            st["plcore_two_pass_steps_overlapped"],
            st["plcore_two_pass_cycles_encode"]) == (3648, 1692, 3)
