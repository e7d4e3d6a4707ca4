"""The port's serving engine: the reference engine's invariants re-proved
with the port's own engine on the CPU (tiny config, HW <= 16, the kernel
wrappers' plain versions), and its images against the reference engine's.

Bit-identity rows: cross-request coalescing and pipeline depth are
invisible in the pixels, the tail pad never leaks, and every recovery
(retry, oracle rung, straggler redispatch) reconstructs a clean run's
pixels exactly. On the CPU the oracle rung (K1 twice) equals K2 bit for
bit; on the card it agrees to 1e-3 (``chip_smoke.py``). Against the
reference engine on the same weights: 1e-3, the tolerance the port's
plain render is held to (``test_torch_pipeline``)."""
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core.pipeline import PackedPlcore as JaxPackedPlcore
from repro.core.plcore import plcore_decls as jax_decls
from repro.models.params import init_params as jax_init
from repro.serving import FaultConfig as JaxFaultConfig
from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import RenderEngine as JaxRenderEngine
from repro.serving import RenderRequest as JaxRequest
from repro.serving import SceneCache as JaxSceneCache
from repro.serving import loadgen as jax_loadgen

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core.pipeline import PackedPlcore, TileHandle
from repro_torch.data import rays as R
from repro_torch.kernels import ops
from repro_torch.runtime.straggler import StragglerConfig
from repro_torch.serving import (STATUSES, FaultConfig, FaultPlan,
                                 RenderEngine, RenderRequest, SceneCache,
                                 SceneLoadError, loadgen)
from repro_torch.serving.scene_cache import plcore_nbytes

TILE = 64
HW = 16
FUSED = dict(use_kernel=True, fuse_two_pass=True)


@pytest.fixture(scope="module")
def setup():
    """Three scenes drawn by the reference's initializer (so the reference
    engine can serve the same weights), handed over as tensors."""
    cfg = jax_tiny()
    jax_sets = {f"scene{i}": jax_init(jax_decls(cfg), jax.random.PRNGKey(i),
                                      "float32") for i in range(3)}
    sets = {k: bridge.to_torch(jax.tree.map(np.asarray, v))
            for k, v in jax_sets.items()}
    return tiny(), sets, jax_sets


def _loader(cfg, sets, **kw):
    kw = {**FUSED, **kw}
    return lambda sid: PackedPlcore(cfg, sets[sid], device="cpu", **kw)


def _engine(cfg, sets, **kw):
    cache = SceneCache(_loader(cfg, sets),
                       capacity_mb=kw.pop("capacity_mb", 256.0))
    return RenderEngine(cache, tile_rays=kw.pop("tile_rays", TILE), **kw)


def _rays(req):
    c2w = R.pose_spherical(req.theta, req.phi, req.radius)
    return R.camera_rays(c2w, req.hw, req.hw, 0.9 * req.hw)


def _reference(cfg, params, req, tile: int = TILE):
    """The per-request image: one ``render_image`` at the tile size."""
    ro, rd = _rays(req)
    pp = PackedPlcore(cfg, params, device="cpu", **FUSED)
    return pp.render_image(ro, rd, rays_per_batch=tile).numpy()


def _run(engine, requests):
    rids = [engine.submit(r) for r in requests]
    engine.drain()
    return {rid: engine.take(rid) for rid in rids}


def _requests(n=4, hw=HW):
    return [RenderRequest(scene_id=f"scene{i % 2}", hw=hw, theta=30.0 * i)
            for i in range(n)]


MIXED = [RenderRequest("scene0", hw=10, theta=10.0),
         RenderRequest("scene1", hw=12, theta=50.0),
         RenderRequest("scene0", hw=10, theta=90.0),
         RenderRequest("scene2", hw=16, theta=130.0),
         RenderRequest("scene1", hw=10, theta=170.0),
         RenderRequest("scene0", hw=12, theta=210.0)]


# ------------------------------------------------------ the parity rows ----
def _engine_imgs(setup, **engine_kw):
    """Two coalescable same-scene requests plus a second resolution,
    images in submit order."""
    cfg, sets, _ = setup
    eng = _engine(cfg, {"s0": sets["scene0"]}, **engine_kw)
    rids = [eng.submit(RenderRequest("s0", hw=h)) for h in (HW, 12, HW)]
    eng.drain()
    out = []
    for rid in rids:
        assert eng.completed[rid].status == "ok"
        out.append(eng.completed[rid].image)
    return out


def _engine_direct_oracle(setup):
    cfg, sets, _ = setup
    return [_reference(cfg, sets["scene0"], RenderRequest("s0", hw=h))
            for h in (HW, 12, HW)]


_MATRIX = {
    "engine_coalesced__direct": (lambda s: _engine_imgs(s),
                                 _engine_direct_oracle),
    "engine_depth3__engine_depth1": (
        lambda s: _engine_imgs(s, pipeline_depth=3),
        lambda s: _engine_imgs(s)),
    # adaptive sampling OFF is the same pipeline as an engine that never
    # heard of it
    "adaptive_off_engine__engine": (
        lambda s: _engine_imgs(s, adaptive_sampling=False),
        lambda s: _engine_imgs(s)),
}


@pytest.mark.parametrize("combo", sorted(_MATRIX))
def test_engine_parity_bit_exact(combo, setup):
    got_fn, want_fn = _MATRIX[combo]
    got, want = got_fn(setup), want_fn(setup)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags", [FUSED, {}])
def test_engine_images_match_reference_engine(setup, flags):
    """The same requests on the same weights through the reference's
    engine and the port's, on the same path (fused kernel or plain):
    within 1e-3, and the same scheduling decisions."""
    cfg, sets, jax_sets = setup
    reqs = MIXED[:4]
    jeng = JaxRenderEngine(JaxSceneCache(
        lambda sid: JaxPackedPlcore(jax_tiny(), jax_sets[sid], **flags)),
        tile_rays=TILE)
    jrids = [jeng.submit(JaxRequest(r.scene_id, hw=r.hw, theta=r.theta))
             for r in reqs]
    jeng.drain()
    eng = RenderEngine(SceneCache(_loader(cfg, sets, **{
        "use_kernel": False, "fuse_two_pass": False, **flags})),
        tile_rays=TILE)
    rids = [eng.submit(r) for r in reqs]
    eng.drain()
    for key in ("dispatches", "dispatch_baseline", "padded_rays",
                "scene_switches", "rays_rendered"):
        assert eng.stats[key] == jeng.stats[key], key
    for rid, jrid in zip(rids, jrids):
        np.testing.assert_allclose(eng.completed[rid].image,
                                   np.asarray(jeng.completed[jrid].image),
                                   rtol=0, atol=1e-3)


# ----------------------------------------------- coalescing correctness ----
def test_mixed_trace_bit_identical_and_fewer_dispatches(setup):
    cfg, sets, _ = setup
    eng = _engine(cfg, sets)
    rids = [eng.submit(r) for r in MIXED]
    eng.drain()
    assert eng.stats["requests_completed"] == len(MIXED)
    for rid, req in zip(rids, MIXED):
        img = eng.completed[rid].image
        assert np.isfinite(img).all()           # NaN fb: no gap, no leak
        np.testing.assert_array_equal(img,
                                      _reference(cfg, sets[req.scene_id], req))
    assert eng.stats["dispatches"] < eng.stats["dispatch_baseline"]
    assert eng.stats["rays_rendered"] == sum(r.hw * r.hw for r in MIXED)


def test_tail_padding_does_not_leak(setup):
    cfg, sets, _ = setup
    eng = _engine(cfg, sets)
    a = RenderRequest("scene0", hw=10, theta=20.0)   # 100 rays
    b = RenderRequest("scene0", hw=10, theta=200.0)  # 100 rays
    ra, rb = eng.submit(a), eng.submit(b)
    eng.drain()
    # 200 rays -> 4 tiles of 64, 56 pad rays in the tail
    assert eng.stats["dispatches"] == 4
    assert eng.stats["padded_rays"] == 56
    for rid, req in ((ra, a), (rb, b)):
        img = eng.completed[rid].image
        assert np.isfinite(img).all()
        np.testing.assert_array_equal(img, _reference(cfg, sets["scene0"],
                                                      req))


def test_priority_completes_out_of_order(setup):
    cfg, sets, _ = setup
    eng = _engine(cfg, sets)
    big = eng.submit(RenderRequest("scene0", hw=16, priority=0))
    small = eng.submit(RenderRequest("scene1", hw=8, priority=1))
    eng.drain()
    assert eng.completion_order == [small, big]
    np.testing.assert_array_equal(
        eng.completed[small].image,
        _reference(cfg, sets["scene1"], RenderRequest("scene1", hw=8)))


def test_sticky_scene_grouping(setup):
    cfg, sets, _ = setup
    eng = _engine(cfg, sets)
    for sid in ("scene0", "scene1", "scene0", "scene1"):
        eng.submit(RenderRequest(sid, hw=10))
    eng.drain()
    assert eng.stats["scene_switches"] == 2
    assert eng.cache.misses == 2


# --------------------------------------------------------- scene cache ----
def test_scene_cache_lru_evicts_and_packs_once(setup):
    cfg, sets, _ = setup
    loader = _loader(cfg, sets)
    two = 2 * plcore_nbytes(loader("scene0")) / (1 << 20)
    cache = SceneCache(loader, capacity_mb=two * 1.25)  # room for 2 scenes
    n0 = ops.pack_count()
    cache.get("scene0")
    cache.get("scene1")
    assert (cache.misses, cache.hits) == (2, 0)
    assert ops.pack_count() - n0 == 4          # coarse + fine per scene
    cache.get("scene0")
    cache.get("scene0")
    assert cache.hits == 2 and ops.pack_count() - n0 == 4
    cache.get("scene2")                        # miss -> evicts scene1
    assert cache.evictions == 1 and "scene1" not in cache
    assert cache.resident_scenes == ["scene0", "scene2"]
    assert ops.pack_count() - n0 == 6
    cache.get("scene1")
    assert cache.misses == 4 and ops.pack_count() - n0 == 8


def test_scene_cache_keeps_just_inserted_when_over_capacity(setup):
    cfg, sets, _ = setup
    cache = SceneCache(_loader(cfg, sets), capacity_mb=1e-6)
    assert cache.get("scene0") is not None and len(cache) == 1
    cache.get("scene1")
    assert cache.resident_scenes == ["scene1"]
    assert cache.evictions == 1


def test_scene_bytes_count_params_quant_and_layout(setup):
    cfg, sets, _ = setup
    pp = _loader(cfg, sets)("scene0")
    want = sum(t.numel() * t.element_size()
               for tree in (pp.params, pp.packed)
               for t in jax.tree.leaves(tree))
    assert plcore_nbytes(pp) == want > 0


# ------------------------------------------------ pipelined executor -------
def test_pipeline_depths_bit_identical(setup):
    cfg, sets, _ = setup
    runs = {}
    for depth in (1, 2, 3):
        eng = _engine(cfg, sets, pipeline_depth=depth)
        rids = [eng.submit(r) for r in MIXED]
        eng.drain()
        assert eng.in_flight_tiles == 0
        runs[depth] = (eng, rids)
    base, base_rids = runs[1]
    assert base.stats["max_in_flight"] == 1
    for depth in (2, 3):
        eng, rids = runs[depth]
        for key in ("dispatches", "padded_rays", "scene_switches"):
            assert eng.stats[key] == base.stats[key]
        assert eng.stats["max_in_flight"] == depth
        for rid, brid in zip(rids, base_rids):
            np.testing.assert_array_equal(eng.completed[rid].image,
                                          base.completed[brid].image)


def test_step_makes_progress_while_in_flight(setup):
    cfg, sets, _ = setup
    eng = _engine(cfg, sets, pipeline_depth=4)
    rid = eng.submit(RenderRequest("scene0", hw=10))   # 100 rays = 2 tiles
    assert eng.step() and eng.step()
    assert eng.in_flight_tiles == 2 and eng.pending == 1
    assert eng.pending_rays == 0
    assert eng.step() and eng.in_flight_tiles == 1
    assert eng.step() and eng.in_flight_tiles == 0 and eng.pending == 0
    assert rid in eng.completed
    assert not eng.step()


def test_inflight_scene_pinned_until_slots_drain(setup):
    cfg, sets, _ = setup
    one = plcore_nbytes(_loader(cfg, sets)("scene0")) / (1 << 20)
    cache = SceneCache(_loader(cfg, sets), capacity_mb=one * 1.25)
    eng = RenderEngine(cache, tile_rays=TILE, pipeline_depth=3)
    eng.submit(RenderRequest("scene0", hw=10))         # 2 tiles
    eng.submit(RenderRequest("scene1", hw=8))
    assert eng.step() and eng.step()                   # scene0 in flight
    assert cache.pinned("scene0") and eng.in_flight_tiles == 2
    eng.step()    # scene1's load overflows the cache; scene0 is pinned
    assert "scene0" in cache and cache.evictions == 0
    assert cache.stats()["pinned_scenes"] >= 1
    eng.drain()
    assert not cache.pinned("scene0")
    assert np.isfinite(eng.completed[0].image).all()
    assert np.isfinite(eng.completed[1].image).all()
    cache.get("scene2")
    assert cache.evictions >= 1 and "scene2" in cache


def test_scene_cache_pin_refcounts():
    blank = SimpleNamespace(params=None, quant=None, packed=None)
    cache = SceneCache(lambda sid: blank, capacity_mb=0.0)
    cache._entries["a"] = (blank, 1 << 20)
    cache.pin("a")
    cache.pin("a")
    cache.get("b")
    assert "a" in cache and cache.evictions == 0
    cache.unpin("a")
    assert cache.pinned("a")                           # refcount nests
    cache.unpin("a")
    cache.get("c")
    assert "a" not in cache and cache.evictions >= 1


def test_latency_splits_into_queueing_plus_service(setup):
    cfg, sets, _ = setup
    eng = _engine(cfg, sets, pipeline_depth=2)
    trace = loadgen.poisson_trace(6, list(sets), rate_rps=100.0,
                                  hw_choices=(8, 12), seed=0)
    rep = loadgen.run_trace(eng, trace, mode="closed", concurrency=3)
    for key in ("latency_ms", "queueing_ms", "service_ms"):
        assert set(rep[key]) == {"p50", "p95", "p99"}
        assert all(v is not None and v >= 0 for v in rep[key].values())
    for res in eng.completed.values():
        assert res.queueing_s >= 0 and res.service_s >= 0
        assert np.isclose(res.queueing_s + res.service_s, res.latency_s)


def test_dispatch_tile_handle_matches_render_tile(setup):
    cfg, sets, _ = setup
    pp = _loader(cfg, sets)("scene0")
    ro, rd = R.camera_rays(R.pose_spherical(30.0, -25.0, 4.0), 8, 8, 7.2)
    o, d = ro.reshape(-1, 3).numpy(), rd.reshape(-1, 3).numpy()
    handle, cost = pp.dispatch_tile(o.copy(), d.copy())
    assert isinstance(handle, TileHandle)
    assert cost == pp.tile_gather_cost() == {"layers": 0, "bytes": 0}
    got = handle.result()
    assert got.dtype == np.float32 and got.shape == (64, 3)
    np.testing.assert_array_equal(got, pp.render_tile(o, d).numpy())


# ----------------------------------------------------------- loadgen -------
def test_poisson_trace_deterministic_and_matches_reference():
    a = loadgen.poisson_trace(8, ["s0", "s1"], rate_rps=100.0, seed=7)
    b = loadgen.poisson_trace(8, ["s0", "s1"], rate_rps=100.0, seed=7)
    c = loadgen.poisson_trace(8, ["s0", "s1"], rate_rps=100.0, seed=8)
    assert a == b and a != c
    assert all(x.arrival_s < y.arrival_s for x, y in zip(a, a[1:]))
    ref = jax_loadgen.poisson_trace(8, ["s0", "s1"], rate_rps=100.0,
                                    hw_choices=(16, 32), priorities=(0, 1),
                                    seed=7)
    ours = loadgen.poisson_trace(8, ["s0", "s1"], rate_rps=100.0,
                                 hw_choices=(16, 32), priorities=(0, 1),
                                 seed=7)
    for x, y in zip(ours, ref):
        assert x.arrival_s == y.arrival_s
        assert vars(x.request) == vars(y.request)


def test_closed_loop_reports_and_completes(setup):
    cfg, sets, _ = setup
    eng = _engine(cfg, sets)
    trace = loadgen.poisson_trace(6, list(sets), rate_rps=100.0,
                                  hw_choices=(8, 12), seed=0)
    rep = loadgen.run_trace(eng, trace, mode="closed", concurrency=3)
    assert rep["requests_completed"] == 6
    assert rep["dispatch_savings"] >= 0
    assert rep["cache"]["hit_rate"] > 0
    assert all(v is not None for v in rep["latency_ms"].values())


def test_open_loop_with_fake_clock_completes(setup):
    cfg, sets, _ = setup
    clk = _FakeClock()
    eng = _engine(cfg, sets, clock=clk)
    trace = loadgen.poisson_trace(4, list(sets), rate_rps=10.0,
                                  hw_choices=(8,), seed=1)
    rep = loadgen.run_trace(eng, trace, mode="open", clock=clk,
                            sleep=clk.advance)
    assert rep["requests_delivered"] == 4 and rep["mode"] == "open"
    assert rep["wall_s"] >= trace[-1].arrival_s
    with pytest.raises(ValueError, match="loadgen mode"):
        loadgen.run_trace(eng, trace, mode="burst")


# -------------------------------------------------------- fault plan -------
def test_fault_plan_deterministic_and_matches_reference():
    a = FaultPlan(FaultConfig.chaos(seed=5))
    b = FaultPlan(FaultConfig.chaos(seed=5))
    j = JaxFaultPlan(JaxFaultConfig.chaos(seed=5))
    draws = [a.draw_dispatch() for _ in range(50)]
    assert draws == [b.draw_dispatch() for _ in range(50)]
    assert draws == [j.draw_dispatch() for _ in range(50)]
    rgb = np.ones((32, 3), np.float32)
    for _ in range(20):
        ca, cj = a.corrupt_tile(rgb), j.corrupt_tile(rgb)
        assert (ca is None) == (cj is None)
        if ca is not None:
            np.testing.assert_array_equal(ca, cj)
    loads = [a.loader_fault("s") for _ in range(20)]
    assert loads == [j.loader_fault("s") for _ in range(20)]
    assert a.total_injected > 0
    np.testing.assert_array_equal(rgb, np.ones((32, 3), np.float32))


def test_fault_plan_straggle_suppressed_in_sync_ladder():
    plan = FaultPlan(FaultConfig(seed=0, straggler_rate=1.0))
    assert plan.draw_dispatch()["kind"] == "straggle"
    assert plan.draw_dispatch(allow_straggle=False) is None
    assert plan.draws["dispatch"] == 2
    assert plan.injected["straggle"] == 1


def test_scene_cache_loader_failure_leaves_no_partial_state(setup):
    cfg, sets, _ = setup
    calls = {"n": 0}
    load = _loader(cfg, sets)

    def flaky(sid):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("checkpoint unreadable")
        return load(sid)

    cache = SceneCache(flaky, capacity_mb=256.0, fail_backoff=2)
    with pytest.raises(SceneLoadError) as ei:
        cache.get("scene0")
    assert not ei.value.fail_fast
    assert "scene0" not in cache
    assert len(cache) == 0 and cache.resident_bytes == 0
    st = cache.stats()
    assert st["load_failures"] == 1 and st["failing_scenes"] == 1
    assert st["resident_scenes"] == 0 and st["pinned_scenes"] == 0
    assert cache.consecutive_failures("scene0") == 1
    for _ in range(2):
        with pytest.raises(SceneLoadError) as ei:
            cache.get("scene0")
        assert ei.value.fail_fast
    assert calls["n"] == 1 and cache.stats()["fail_fasts"] == 2
    pp = cache.get("scene0")
    assert pp is cache.get("scene0")
    assert cache.consecutive_failures("scene0") == 0
    assert cache.stats()["failing_scenes"] == 0


# ---------------------------------------------------- recovery ladder ------
@pytest.mark.parametrize("site", ["dispatch_error_rate", "corrupt_rate"])
def test_faulted_tiles_recovered_bit_exact(setup, site):
    """Every dispatch raises (or every drained tile is corrupt): the
    ladder resolves each tile and the pixels equal a clean run's."""
    cfg, sets, _ = setup
    reqs = _requests()
    clean = _run(_engine(cfg, sets), reqs)
    plan = FaultPlan(FaultConfig(seed=1, **{site: 1.0}))
    eng = _engine(cfg, sets, faults=plan)
    faulty = _run(eng, reqs)
    if site == "dispatch_error_rate":
        assert eng.stats["dispatch_errors"] > 0
        assert eng.stats["oracle_fallbacks"] == eng.stats["dispatches"] > 0
    else:
        assert eng.stats["corrupt_tiles"] > 0
        assert eng.stats["oracle_fallbacks"] >= 1
    for rid, res in faulty.items():
        assert res.status == "ok" and res.retries > 0
        np.testing.assert_array_equal(res.image, clean[rid].image)


class _NaNPlcore:
    """A resident whose every program returns NaN: weights poisoned
    beyond what retry or the oracle can fix."""

    view_rays = staticmethod(R.nerf_view_rays)

    def __init__(self, pp):
        self.params, self.quant, self.packed = pp.params, pp.quant, pp.packed

    def dispatch_tile(self, o, d, coarse_only=False):
        return TileHandle(torch.full((len(o), 3), float("nan"))), \
            self.tile_gather_cost()

    def render_tile(self, o, d, coarse_only=False):
        return torch.full((len(o), 3), float("nan"))

    render_tile_oracle = render_tile

    def tile_gather_cost(self):
        return {"layers": 0, "bytes": 0}


@pytest.mark.parametrize("check_finite", [True, False])
def test_check_finite_guards_delivered_framebuffers(setup, check_finite):
    cfg, sets, _ = setup
    load = _loader(cfg, sets)
    eng = RenderEngine(SceneCache(lambda sid: _NaNPlcore(load(sid))),
                       tile_rays=TILE, check_finite=check_finite)
    rid = eng.submit(RenderRequest(scene_id="scene0", hw=8))
    if check_finite:
        with pytest.raises(RuntimeError, match="non-finite"):
            eng.drain()
        return
    eng.drain()
    res = eng.take(rid)
    assert res.status == "ok" and np.isnan(res.image).all()


# -------------------------------------------- admission and deadlines ------
class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_bounded_queue_rejects_at_admission(setup):
    cfg, sets, _ = setup
    eng = _engine(cfg, sets, max_queue=1)
    rid_a = eng.submit(RenderRequest(scene_id="scene0", hw=8))
    rid_b = eng.submit(RenderRequest(scene_id="scene0", hw=8))
    res_b = eng.take(rid_b)
    assert res_b.status == "rejected" and "queue full" in res_b.error
    eng.drain()
    assert eng.take(rid_a).status == "ok"
    assert eng.stats["status_counts"] == {"ok": 1, "rejected": 1}


def test_slo_admission_control_rejects_predicted_miss(setup):
    cfg, sets, _ = setup
    eng = _engine(cfg, sets)
    eng.submit(RenderRequest(scene_id="scene0", hw=16))       # backlog
    eng.stats["tile_service_s_ewma"] = 10.0
    rid = eng.submit(RenderRequest(scene_id="scene0", hw=8, deadline_s=0.5))
    res = eng.take(rid)
    assert res.status == "rejected" and "admission control" in res.error
    rid2 = eng.submit(RenderRequest(scene_id="scene0", hw=8,
                                    deadline_s=1e6))
    assert rid2 not in eng.completed
    eng.stats["tile_service_s_ewma"] = None
    eng.drain()
    assert eng.take(rid2).status == "ok"


def test_cold_start_admission_uses_service_prior(setup):
    cfg, sets, _ = setup
    eng = _engine(cfg, sets, tile_service_prior_s=10.0)
    assert eng.stats["tile_service_s_ewma"] is None
    eng.submit(RenderRequest(scene_id="scene0", hw=16))
    rid = eng.submit(RenderRequest(scene_id="scene0", hw=8, deadline_s=0.5))
    res = eng.take(rid)
    assert res.status == "rejected" and "admission control" in res.error
    eng2 = _engine(cfg, sets)
    eng2.submit(RenderRequest(scene_id="scene0", hw=16))
    rid2 = eng2.submit(RenderRequest(scene_id="scene0", hw=8,
                                     deadline_s=0.5))
    assert rid2 not in eng2.completed          # no estimate: admitted
    eng.drain()
    eng2.drain()
    eng.stats["tile_service_s_ewma"] = 1e-6    # a measurement outranks it
    rid3 = eng.submit(RenderRequest(scene_id="scene0", hw=8, deadline_s=0.5))
    assert rid3 not in eng.completed
    eng.drain()
    assert eng.take(rid3).status == "ok"


def test_deadline_expiry_statuses(setup):
    cfg, sets, _ = setup
    clk = _FakeClock()
    eng = _engine(cfg, sets, clock=clk)
    rid_e = eng.submit(RenderRequest(scene_id="scene0", hw=8,
                                     deadline_s=1.0))
    clk.advance(2.0)
    eng.step()
    res_e = eng.completed[rid_e]
    assert res_e.status == "expired" and np.isnan(res_e.image).all()
    rid_p = eng.submit(RenderRequest(scene_id="scene0", hw=16,
                                     deadline_s=1.0))
    eng.step()                                # one 64-ray tile scatters
    clk.advance(2.0)
    eng.step()
    res_p = eng.completed[rid_p]
    assert res_p.status == "partial"
    flat = res_p.image.reshape(-1, 3)
    assert np.isfinite(flat[:TILE]).all()
    assert np.isnan(flat[TILE:]).all()
    assert eng.pending == 0


def test_late_scatter_after_expiry_is_dropped(setup):
    cfg, sets, _ = setup
    clk = _FakeClock()
    eng = _engine(cfg, sets, clock=clk, pipeline_depth=3)
    rid = eng.submit(RenderRequest(scene_id="scene0", hw=8, deadline_s=1.0))
    eng.step()                                # tile in flight, not drained
    assert eng.in_flight_tiles == 1
    clk.advance(2.0)
    eng.drain()
    assert eng.completed[rid].status == "expired"
    assert eng.stats["late_rays"] == 64       # scattered into the void
    assert eng.in_flight_tiles == 0


def test_priority_aging_bounds_starvation(setup):
    cfg, sets, _ = setup

    def order(aging):
        eng = _engine(cfg, sets, aging_tiles=aging)
        low = eng.submit(RenderRequest(scene_id="scene0", hw=16, priority=0))
        last_high = None
        for i in range(3):
            last_high = eng.submit(RenderRequest(
                scene_id="scene0", hw=16, priority=1, theta=10.0 * i))
            for _ in range(4):
                eng.step()
        eng.drain()
        return (eng.completion_order.index(low),
                eng.completion_order.index(last_high))

    lo, hi = order(None)
    assert lo > hi                 # no aging: starved past every arrival
    lo, hi = order(1)
    assert lo < hi                 # aged ahead of later arrivals


def test_overload_degradation_delivers_coarse_image(setup):
    cfg, sets, _ = setup
    cache = SceneCache(_loader(cfg, sets))
    eng = RenderEngine(cache, tile_rays=TILE, degrade_on_overload=True,
                       degrade_queue_tiles=2, degrade_max_priority=0)
    reqs = [RenderRequest(scene_id="scene0", hw=16, theta=15.0 * i)
            for i in range(3)]                # 12 queued tiles > 2
    results = _run(eng, reqs)
    assert eng.stats["degraded_requests"] == 3
    assert eng.stats["degraded_tiles"] == eng.stats["dispatches"] > 0
    assert eng.robustness()["goodput"] == 1.0
    pp = cache.get("scene0")
    for r, res in zip(reqs, results.values()):
        assert res.status == "degraded"
        ro, rd = _rays(r)
        ref = pp.render_tile(ro.reshape(-1, 3), rd.reshape(-1, 3),
                             coarse_only=True).numpy()
        np.testing.assert_array_equal(res.image, ref.reshape(r.hw, r.hw, 3))


def test_straggler_redispatch_avoids_paying_the_stall(setup):
    cfg, sets, _ = setup
    plan = FaultPlan(FaultConfig(seed=0, straggler_rate=1.0,
                                 straggler_extra_s=30.0))
    clean = _run(_engine(cfg, sets), _requests(n=2))
    eng = _engine(cfg, sets, faults=plan,
                  straggler_cfg=StragglerConfig(warmup_steps=0,
                                                deadline_factor=2.0,
                                                ewma_alpha=0.01))
    eng.executor.straggler.record_step(1e-3)   # a fast baseline
    t0 = time.perf_counter()
    results = _run(eng, _requests(n=2))
    assert time.perf_counter() - t0 < 25.0
    assert eng.stats["straggler_redispatches"] == eng.stats["dispatches"] > 0
    assert eng.stats["straggle_wait_s"] == 0.0
    for rid, res in results.items():
        assert res.status == "ok"
        np.testing.assert_array_equal(res.image, clean[rid].image)


# ---------------------------------------------------- chaos acceptance -----
def test_seeded_chaos_trace_terminates_with_exact_recovery(setup):
    cfg, sets, _ = setup
    reqs = [RenderRequest(scene_id=f"scene{i % 3}", hw=HW, theta=20.0 * i,
                          priority=i % 2) for i in range(8)]
    clean = _run(_engine(cfg, sets), reqs)
    plan = FaultPlan(FaultConfig.chaos(seed=0))
    eng = RenderEngine(SceneCache(plan.wrap_loader(_loader(cfg, sets))),
                       tile_rays=TILE, faults=plan, max_queue=64,
                       aging_tiles=8)
    results = _run(eng, reqs)
    rb = eng.robustness()
    assert plan.total_injected > 0
    assert sum(rb["status_counts"].values()) == len(reqs)
    assert rb["goodput"] >= 0.75
    for rid, res in results.items():
        assert res.status in STATUSES
        if res.status == "ok":
            np.testing.assert_array_equal(res.image, clean[rid].image)


def test_fuzz_random_interleaving_always_terminates(setup):
    cfg, sets, _ = setup
    rng = np.random.RandomState(7)
    plan = FaultPlan(FaultConfig.chaos(seed=3))
    eng = RenderEngine(SceneCache(plan.wrap_loader(_loader(cfg, sets))),
                       tile_rays=32, faults=plan, max_queue=16, aging_tiles=4,
                       degrade_on_overload=True, degrade_queue_tiles=4)
    submitted, taken = set(), {}
    for _ in range(6):
        for _ in range(int(rng.randint(0, 4))):
            dl = (None, 0.05, 5.0)[int(rng.randint(3))]
            submitted.add(eng.submit(RenderRequest(
                scene_id=f"scene{int(rng.randint(3))}", hw=8,
                theta=float(rng.uniform(0.0, 360.0)),
                priority=int(rng.randint(2)), deadline_s=dl)))
        for _ in range(int(rng.randint(0, 6))):
            eng.step()
        for rid in list(eng.completed):
            if rng.random_sample() < 0.5:
                taken[rid] = eng.take(rid)
    steps = eng.drain(max_steps=20000)
    assert steps < 20000
    assert eng.pending == 0 and eng.in_flight_tiles == 0
    results = dict(taken)
    results.update(eng.completed)
    assert set(results) == submitted
    assert eng.stats["requests_completed"] == len(submitted)
    for res in results.values():
        assert res.status in STATUSES
        if res.delivered:
            assert np.isfinite(res.image).all()
