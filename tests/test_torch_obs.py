"""The port's copies of the reference's observability and straggler
modules, against the reference's on the same inputs, and the tracer on the
port's engine."""
import numpy as np
import pytest
import torch

from repro.runtime.straggler import StragglerConfig as JaxStragglerConfig
from repro.runtime.straggler import StragglerMonitor as JaxStragglerMonitor

from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.core.plcore import plcore_decls
from repro_torch.models.params import init_params
from repro_torch.obs.metrics import (ENGINE_STATS_SCHEMA, MetricsRegistry,
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
