"""The port's observability exporters and validator (``obs/export.py``)
against the reference's: the reference's ``tests/test_obs.py`` export and
validation cases re-run on the port's engine, spans and registries, the
two packages' exporters on one span stream (equal JSON, equal Prometheus
text), the device spans a traced engine records on the card (with fake
CUDA events here), the busy share, and the kernel counters on the
process-wide registry."""
import json

import pytest
import torch

from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro.obs import Span as JaxSpan
from repro.obs import chrome_trace as jax_chrome_trace
from repro.obs import prometheus_text as jax_prometheus_text
from repro.obs import snapshot as jax_snapshot
from repro.obs import validate_trace as jax_validate_trace

from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core.pipeline import PackedPlcore, TileHandle
from repro_torch.core.plcore import plcore_decls
from repro_torch.kernels import fused_plcore, ops
from repro_torch.models.params import init_params
from repro_torch.obs import (CountsView, MetricsRegistry, Span, SpanTracer,
                             chrome_trace, device_busy, global_registry,
                             prometheus_text, snapshot,
                             validate_chrome_trace, validate_trace)
from repro_torch.serving import (FaultConfig, FaultPlan, RenderEngine,
                                 RenderRequest, SceneCache)

TILE = 64


@pytest.fixture(scope="module")
def param_sets():
    cfg = tiny()
    return cfg, {f"scene{i}": init_params(plcore_decls(cfg),
                                          torch.Generator().manual_seed(i))
                 for i in range(2)}


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-4
        return self.t


def _loader(cfg, params):
    return lambda sid: PackedPlcore(cfg, params[sid], device="cpu")


def _traced_run(cfg, params, *, faults=None, registry=None):
    clk = _FakeClock()
    tr = SpanTracer(clock=clk)
    eng = RenderEngine(SceneCache(_loader(cfg, params)), tile_rays=TILE,
                       pipeline_depth=2, clock=clk, tracer=tr,
                       faults=faults, registry=registry)
    rids = [eng.submit(RenderRequest(scene_id=f"scene{i % 2}", hw=12,
                                     theta=30.0 * i)) for i in range(4)]
    eng.drain()
    for rid in rids:
        eng.take(rid)
    return tr, eng


def _to_reference(spans):
    return [JaxSpan(s.sid, s.name, s.cat, s.ph, s.t0, s.t1, dict(s.attrs))
            for s in spans]


def _mirror(reg: MetricsRegistry) -> JaxMetricsRegistry:
    """The reference registry holding the same families, children and
    values as the port's."""
    out = JaxMetricsRegistry()
    for fam in reg.families():
        make = {"counter": out.counter, "gauge": out.gauge}.get(fam.kind)
        f = (out.histogram(fam.name, fam.help, buckets=fam.buckets)
             if fam.kind == "histogram" else make(fam.name, fam.help))
        for key, child in fam.children():
            c = f.labels(**dict(key))
            if fam.kind == "histogram":
                c.counts, c.sum, c.count = list(child.counts), child.sum, \
                    child.count
            else:
                c.value = child.value
    return out


# ------------------------------------------------------ chain completeness --
def test_span_chain_complete_under_chaos(param_sets):
    cfg, params = param_sets
    tr, _ = _traced_run(cfg, params,
                        faults=FaultPlan(FaultConfig.chaos(seed=3)))
    out = validate_trace(tr)
    assert out["ok"], out["errors"]
    assert out["dispatched_tiles"] >= 1 and out["requests"] == 4
    names = {s.name for s in tr.spans()}
    assert {"request.submit", "request.admit", "tile.coalesce",
            "tile.dispatch", "tile.device_compute", "tile.drain",
            "tile.scatter", "request.complete", "request",
            "cache.load"} <= names
    # on the CPU no device span: the chain is the reference's
    assert "tile.kernel" not in names and \
        device_busy(tr)["busy_share"] is None


# -------------------------------------------------------------- exporters --
def test_chrome_trace_structure_and_revalidation(param_sets):
    cfg, params = param_sets
    tr, _ = _traced_run(cfg, params)
    obj = chrome_trace(tr)
    evs = obj["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in evs)
    data = [e for e in evs if e["ph"] != "M"]
    assert all({"name", "cat", "ts", "pid", "tid"} <= set(e) for e in data)
    assert all("dur" in e for e in data if e["ph"] == "X")
    assert min(e["ts"] for e in data) == 0.0
    slots = {e["tid"] for e in data if e["name"] == "tile.device_compute"}
    assert slots and all(t >= 10 for t in slots)
    out = validate_chrome_trace(json.loads(json.dumps(obj)))
    assert out["ok"], out["errors"]
    assert out["dispatched_tiles"] >= 1


def test_prometheus_text_format(param_sets):
    cfg, params = param_sets
    reg = MetricsRegistry()
    eng = RenderEngine(SceneCache(_loader(cfg, params)), tile_rays=TILE,
                       registry=reg)
    rid = eng.submit(RenderRequest(scene_id="scene0", hw=16))
    eng.drain()
    eng.take(rid)
    lines = prometheus_text(reg).splitlines()
    assert "# TYPE engine_dispatches_total counter" in lines
    assert any(l.startswith("engine_dispatches_total ") for l in lines)
    assert any(l.startswith('engine_requests_by_status_total{status="ok"}')
               for l in lines)
    bucket = [l for l in lines
              if l.startswith("engine_tile_service_seconds_bucket")]
    assert bucket and bucket[-1].split('le="')[1].startswith("+Inf")
    assert any(l.startswith("engine_tile_service_seconds_count ")
               for l in lines)
    # a gauge never observed (None) is skipped, not exported as 0
    reg.gauge("engine_never_observed", "a gauge left at None").set(None)
    assert "engine_never_observed" not in \
        prometheus_text(reg).split("# TYPE engine_never_observed gauge")[1]
    snap = snapshot(reg)
    assert snap["engine_dispatches_total"]["series"][0]["value"] \
        == eng.stats["dispatches"]


def test_exporters_equal_the_references_on_one_stream(param_sets):
    """One chaos run's span stream and registries through both packages'
    exporters: equal Chrome trace JSON, equal validator verdicts, equal
    Prometheus text and snapshot."""
    cfg, params = param_sets
    reg = MetricsRegistry()
    tr, _ = _traced_run(cfg, params, registry=reg,
                        faults=FaultPlan(FaultConfig.chaos(seed=5)))
    spans = tr.spans() + tr.open_spans()
    ours = json.dumps(chrome_trace(tr), sort_keys=True)
    theirs = json.dumps(jax_chrome_trace(_to_reference(spans)),
                        sort_keys=True)
    assert ours == theirs
    assert validate_trace(tr.spans()) == jax_validate_trace(
        _to_reference(tr.spans()))
    mirror = _mirror(reg)
    assert prometheus_text(reg) == jax_prometheus_text(mirror)
    assert snapshot(reg) == jax_snapshot(mirror)


# ------------------------------------------------------- validator teeth --
def _tile_ev(sid, name, tid):
    return Span(sid, name, "tile", "i", float(sid), float(sid),
                {"tile": tid})


def test_validator_catches_orphan_dispatch():
    out = validate_trace([_tile_ev(0, "tile.dispatch", 1),
                          _tile_ev(1, "tile.drain", 1)])
    assert not out["ok"]
    assert any("non-terminal" in e for e in out["errors"])


def test_validator_catches_double_serve_and_dangling_request():
    spans = [_tile_ev(0, "tile.dispatch", 1),
             _tile_ev(1, "tile.scatter", 1),
             _tile_ev(2, "tile.dispatch", 1),
             _tile_ev(3, "tile.scatter", 1),
             Span(4, "request.submit", "request", "i", 4.0, 4.0,
                  {"request": 0})]
    out = validate_trace(spans)
    assert not out["ok"]
    msgs = "\n".join(out["errors"])
    assert "dispatched again after terminal" in msgs
    assert "request 0" in msgs


def test_validator_accepts_legal_retry_chain():
    spans = [_tile_ev(0, "tile.dispatch", 1),
             _tile_ev(1, "tile.abandon", 1),
             _tile_ev(2, "tile.dispatch", 1),
             _tile_ev(3, "tile.drain", 1),
             _tile_ev(4, "tile.scatter", 1),
             _tile_ev(5, "tile.drop", 2)]
    out = validate_trace(spans)
    assert out["ok"], out["errors"]
    assert out["tiles"] == 2 and out["dispatched_tiles"] == 1


# ------------------------------------------------------------ device spans --
class _FakeEvent:
    """A CUDA event stand-in whose device time is set by the test."""
    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = _FakeEvent.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def test_device_span_lands_on_the_tracers_clock(param_sets, monkeypatch):
    """The executor's anchor maps a tile's CUDA events onto the tracer's
    clock: ``tile.kernel`` starts and ends where the device events say,
    on its own track (category device, one per device); the chain's
    validator is unchanged by it; the busy share is the spans' union over
    the traced window."""
    cfg, params = param_sets
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    host = [10.0]
    tr = SpanTracer(clock=lambda: host[0])
    eng = RenderEngine(SceneCache(_loader(cfg, params)), tile_rays=TILE,
                       tracer=tr)
    ex = eng.executor

    class _Tile:
        tid = 7
        pp = type("pp", (), {"device": torch.device("cuda", 1)})()

    _FakeEvent.clock[0] = 100.0          # device time at the anchor
    ex._device_clock(_Tile)
    start, end = _FakeEvent(), _FakeEvent()
    _FakeEvent.clock[0] = 100.002
    start.record()
    _FakeEvent.clock[0] = 100.005
    end.record()
    handle = TileHandle(torch.zeros(1, 3), end, None, start)
    host[0] = 11.0
    ex._device_span(_Tile, handle)
    (sp,) = [s for s in tr.spans() if s.name == "tile.kernel"]
    assert sp.cat == "device" and sp.attrs == {"tile": 7, "device": 1}
    assert sp.t0 == pytest.approx(10.002) and sp.t1 == pytest.approx(10.005)
    evs = chrome_trace(tr)["traceEvents"]
    (ev,) = [e for e in evs if e.get("name") == "tile.kernel"]
    assert ev["tid"] == 101
    assert {"name": "thread_name", "ph": "M", "pid": 0, "tid": 101,
            "args": {"name": "device 1"}} in evs
    assert validate_chrome_trace(chrome_trace(tr))["ok"]
    # a CPU handle (no events) adds nothing
    ex._device_span(_Tile, TileHandle(torch.zeros(1, 3)))
    assert sum(s.name == "tile.kernel" for s in tr.spans()) == 1


def test_device_busy_is_the_union_over_the_window():
    def k(sid, t0, t1):
        return Span(sid, "tile.kernel", "device", "X", t0, t1,
                    {"tile": sid, "device": 0})
    spans = [Span(0, "tile.dispatch", "tile", "i", 0.0, 0.0, {"tile": 0}),
             k(1, 1.0, 3.0), k(2, 2.0, 4.0), k(3, 6.0, 7.0),
             Span(4, "tile.scatter", "tile", "i", 10.0, 10.0, {"tile": 0})]
    out = device_busy(spans)
    assert out["kernel_spans"] == 3
    assert out["busy_s"] == pytest.approx(4.0)
    assert out["window_s"] == pytest.approx(10.0)
    assert out["busy_share"] == pytest.approx(0.4)


def test_tracer_complete_takes_an_end_time():
    tr = SpanTracer(clock=lambda: 5.0)
    a = tr.complete("x", 1.0, cat="device", t1=2.5, tile=1)
    b = tr.complete("y", 1.0)
    assert (a.t0, a.t1, b.t1) == (1.0, 2.5, 5.0)


def test_port_exports_the_references_names():
    """``repro_torch.obs`` exports every name ``repro.obs`` does; the
    cluster stats schema equals the reference's."""
    import repro.obs as jobs
    import repro_torch.obs as tobs
    assert set(jobs.__all__) <= set(tobs.__all__)
    assert tobs.CLUSTER_STATS_SCHEMA == jobs.CLUSTER_STATS_SCHEMA
    # the engine's keys in the reference's order, less the shard routing
    # the single-host port does not have
    assert [r[0] for r in tobs.ENGINE_STATS_SCHEMA] == [
        r[0] for r in jobs.ENGINE_STATS_SCHEMA if r[0] != "routed_tiles"]


# -------------------------------------------------------- kernel counters --
def test_kernel_counters_live_on_the_global_registry(param_sets):
    """``pack_count``/``dispatch_count`` read counters of the process-wide
    registry; the wrappers' launch counts are dict views of labeled
    families there (writes mirror, ``clear`` zeroes the children), and the
    Prometheus text carries them."""
    cfg, params = param_sets
    reg = global_registry()
    packs = reg.get("plcore_weight_packs_total")
    n0 = ops.pack_count()
    assert n0 == packs.value
    PackedPlcore(cfg, params["scene0"], use_kernel=True, device="cpu")
    assert ops.pack_count() == n0 + 2 == packs.value
    assert ops.dispatch_count() == reg.get(
        "plcore_kernel_dispatches_total").value
    fam = reg.get("plcore_kernel_launches_total")
    assert set(fused_plcore.LAUNCHES) == {"fused_plcore_call",
                                          "two_pass_plcore_call"}
    view = CountsView(MetricsRegistry().counter("t_total"), "k", ("a",))
    view["b"] = 3
    view.update(a=2)
    assert dict(view) == {"a": 2, "b": 3}
    view.clear()
    assert dict(view) == {} and \
        [c.value for _, c in view._family.children()] == [0, 0]
    text = prometheus_text(reg)
    assert "# TYPE plcore_kernel_launches_total counter" in text
    assert 'plcore_kernel_launches_total{kernel="two_pass_plcore_call"}' \
        in text
    assert fam.labels(kernel="fused_plcore_call").value == \
        fused_plcore.LAUNCHES["fused_plcore_call"]
