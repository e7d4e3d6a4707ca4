"""The port's multi-host serving cluster on the CPU (tiny config, the kernel
wrappers' plain versions), after the reference's ``tests/test_cluster.py``:
device split, placement scoring, a kill with tiles in flight re-queued and
re-rendered bit for bit on another host, a kill at a dispatch count, the
cross-host failover hook, per-host quarantine with probes, a scene dead
only when every host has it quarantined, aggregate admission, drain with
affinity migration and rejoin, a hung host killed, a slow host flagged
suspect, the stats and robustness schema, and a fuzzed interleaving that
always terminates. Against the reference on the same inputs: device
groups, host fault draws and overload schedules equal; a closed-loop
two-host chaos run with a kill on the same step clock gives equal statuses
and clock-free cluster counters, and images within 1e-3 (the tolerance the
port's engine is held to in ``test_torch_engine``). Then ``serve --hosts``,
its flag checks, the span chain under a kill and the per-host metric
families.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core.pipeline import PackedPlcore as JaxPackedPlcore
from repro.core.plcore import plcore_decls as jax_decls
from repro.models.params import init_params as jax_init
from repro.serving import ClusterEngine as JaxClusterEngine
from repro.serving import FaultConfig as JaxFaultConfig
from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import HostEvent as JaxHostEvent
from repro.serving import SceneCache as JaxSceneCache
from repro.serving import loadgen as jax_loadgen
from repro.serving import split_devices as jax_split_devices

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core.pipeline import PackedPlcore, TileHandle
from repro_torch.launch import serve
from repro_torch.obs import SpanTracer
from repro_torch.obs.export import prometheus_text, validate_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime import sharding as rsh
from repro_torch.serving import (HOST_STATES, STATUSES, ClusterEngine,
                                 FaultConfig, FaultPlan, HostEvent,
                                 RenderEngine, RenderRequest, SceneCache,
                                 loadgen, split_devices)

TILE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the test
    workers that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Three scenes drawn by the reference's initializer (so the reference
    cluster can serve the same weights), handed over as tensors."""
    jax_sets = {f"scene{i}": jax_init(jax_decls(jax_tiny()),
                                      jax.random.PRNGKey(i), "float32")
                for i in range(3)}
    sets = {k: bridge.to_torch(jax.tree.map(np.asarray, v))
            for k, v in jax_sets.items()}
    return tiny(), sets, jax_sets


def _loader(cfg, sets):
    return lambda sid: PackedPlcore(cfg, sets[sid], device="cpu",
                                    use_kernel=True, fuse_two_pass=True)


def _cluster(cfg, sets, n_hosts=2, **kw):
    caches = [SceneCache(_loader(cfg, sets), capacity_mb=256.0)
              for _ in range(n_hosts)]
    return ClusterEngine(caches, **kw)


def _run(engine, requests):
    rids = [engine.submit(r) for r in requests]
    engine.drain()
    return {rid: engine.take(rid) for rid in rids}


def _requests(n=4, hw=16):
    return [RenderRequest(scene_id=f"scene{i % 2}", hw=hw, theta=30.0 * i)
            for i in range(n)]


def _clean(cfg, sets, reqs):
    return _run(RenderEngine(SceneCache(_loader(cfg, sets)), tile_rays=TILE),
                reqs)


# ----------------------------------------------------------- device split --
def test_split_devices_contiguous_groups():
    assert split_devices(2, devices=list(range(8))) == [[0, 1, 2, 3],
                                                        [4, 5, 6, 7]]
    # fewer devices than hosts: every host shares the full list
    assert split_devices(3, devices=[0, 1]) == [[0, 1], [0, 1], [0, 1]]
    with pytest.raises(ValueError):
        split_devices(0)
    cells = split_devices(2, ["cpu"] * 8)
    assert [len(g) for g in cells] == [4, 4]
    assert [len(rsh.plcore_mesh(devices=g)) for g in cells] == [4, 4]
    if not torch.cuda.is_available():
        # the default is every visible card: none here, so it refuses
        with pytest.raises(RuntimeError, match="no CUDA device"):
            split_devices(2)


@pytest.mark.parametrize("n_hosts,devices", [
    (2, list(range(8))), (3, list(range(8))), (3, [0, 1]), (1, [0, 1, 2]),
    (4, ["a", "b", "c", "d", "e"]), (2, ["cpu"])])
def test_split_devices_matches_reference(n_hosts, devices):
    assert split_devices(n_hosts, devices=devices) == \
        jax_split_devices(n_hosts, devices=devices)


# -------------------------------------------------------------- placement --
def test_placement_scoring(setup):
    cfg, sets, _ = setup
    eng = _cluster(cfg, sets, tile_rays=TILE)
    sched, pool = eng.scheduler, eng.pool
    h0, h1 = pool.get(0), pool.get(1)
    # residency (+4) dominates the hash tie-break
    h0.cache.get("scene0")
    assert sched._place("scene0").id == 0
    # health dominates residency: suspect 4 + resident 4 < healthy 10
    h0.state = "suspect"
    assert sched._place("scene0").id == 1
    h0.state = "healthy"
    # exclusion and quarantine both remove a host from consideration
    assert sched._place("scene0", exclude={0}).id == 1
    sched._quarantine[(0, "scene0")] = 5
    assert sched._place("scene0", exclude={1}) is None
    del sched._quarantine[(0, "scene0")]
    # dead and draining hosts are never placeable
    h0.state, h1.state = "dead", "draining"
    assert sched._place("scene0") is None


# ------------------------------------------------------------ host kill ----
def test_kill_with_in_flight_requeues_and_recovers_bit_exact(setup):
    cfg, sets, _ = setup
    reqs = _requests(n=4)
    clean = _clean(cfg, sets, reqs)
    eng = _cluster(cfg, sets, tile_rays=TILE, pipeline_depth=2)
    rids = [eng.submit(r) for r in reqs]
    # step until a host holds in-flight slots, then kill THAT host: its
    # tiles' pixels have no other way home than the re-queue lane
    victim = None
    for _ in range(200):
        eng.step()
        busy = [h for h in eng.pool if h.executor.in_flight > 0]
        if busy:
            victim = busy[0]
            break
    assert victim is not None
    eng._kill_host(victim)
    eng.drain()
    st = eng.stats
    assert st["host_kills"] == 1
    assert st["requeued_tiles"] >= 1
    assert st["failovers"] >= 1                 # re-queued tile dispatched
    assert st["cross_host_redispatches"] >= 1   # ... on a DIFFERENT host
    assert victim.summary()["state"] == "dead"
    assert eng.pending == 0 and eng.in_flight_tiles == 0
    for rid in rids:
        res = eng.take(rid)
        assert res.status == "ok"
        np.testing.assert_array_equal(res.image, clean[rid].image)


class _PendingHandle(TileHandle):
    """A handle whose work has not run: ``result()`` must not be called
    by an abandon (it would wait on the card)."""

    def __init__(self):
        super().__init__(torch.zeros(1, 3))
        self.waited = False

    def result(self):
        self.waited = True
        raise AssertionError("abandon_all waited on a dropped tile")

    def done(self):
        return False


@pytest.mark.parametrize("percell", [False, True])
def test_abandon_all_drops_every_ring_without_waiting(setup, percell):
    """``abandon_all`` empties the sequential ring and every cell's ring,
    releases the pins, ends each slot span with ``abandoned=True`` and a
    ``tile.abandon`` event, never calls ``result()``, and keeps the
    handles of work not yet run; the re-queued tiles render bit for bit
    on the other host."""
    cfg, sets, _ = setup
    import dataclasses
    cfg8 = dataclasses.replace(cfg, trunk_layers=8, skip_at=(4,))
    from repro_torch.core.plcore import plcore_decls
    from repro_torch.models.params import init_params
    sets8 = {f"scene{i}": init_params(plcore_decls(cfg8),
                                      torch.Generator().manual_seed(i))
             for i in range(2)}
    meshes = [None, None]
    kw = {}
    if percell:
        meshes = [rsh.plcore_mesh(devices=g)
                  for g in split_devices(2, ["cpu"] * 8)]
        kw = dict(route_by_shard=True, percell_dispatch=True)

    def loader(mesh):
        return lambda sid: PackedPlcore(
            cfg8, sets8[sid], use_kernel=True, fuse_two_pass=True,
            **({"shard_mesh": mesh} if mesh else {"device": "cpu"}))

    reqs = _requests(n=4)
    clean = _run(RenderEngine(SceneCache(loader(None)), tile_rays=TILE),
                 reqs)
    tr = SpanTracer()
    eng = ClusterEngine([SceneCache(loader(m)) for m in meshes],
                        meshes=meshes, tile_rays=TILE, pipeline_depth=3,
                        tracer=tr, **kw)
    rids = [eng.submit(r) for r in reqs]
    victim = None
    for _ in range(200):
        eng.step()
        busy = [h for h in eng.pool if h.executor.in_flight >= 2]
        if busy:
            victim = busy[0]
            break
    assert victim is not None
    ex = victim.executor
    pending = _PendingHandle()
    tile, _h, t0, extra, sp = ex._slots[0]
    ex._slots[0] = (tile, pending, t0, extra, sp)
    n = ex.in_flight
    pinned = {t.scene_id for t, *_ in ex._slots}
    eng._kill_host(victim)
    assert not pending.waited and ex._abandoned == [pending]
    assert ex.in_flight == 0 and eng.stats["requeued_tiles"] == n
    assert not any(victim.cache.pinned(s) for s in pinned)
    names = [s.name for s in tr.spans()]
    assert names.count("tile.abandon") == n
    assert sum(1 for s in tr.spans() if s.name == "tile.device_compute"
               and s.attrs.get("abandoned")) == n
    eng.drain()
    assert eng.stats["failovers"] == n
    for rid in rids:
        res = eng.take(rid)
        assert res.status == "ok"
        np.testing.assert_array_equal(res.image, clean[rid].image)


def test_drain_all_flushes_every_slot(setup):
    cfg, sets, _ = setup
    reqs = _requests(n=2)
    clean = _clean(cfg, sets, reqs)
    eng = _cluster(cfg, sets, tile_rays=TILE, pipeline_depth=4)
    rids = [eng.submit(r) for r in reqs]
    while eng.scheduler.queue and all(a.remaining for a in
                                      eng.scheduler.queue):
        eng.step()
    assert eng.in_flight_tiles >= 2
    for h in eng.pool:
        h.executor.drain_all()
        assert h.executor.in_flight == 0
    eng.drain()
    for rid in rids:
        np.testing.assert_array_equal(eng.take(rid).image, clean[rid].image)


def test_kill_event_fires_at_dispatch_count(setup):
    cfg, sets, _ = setup
    eng = _cluster(cfg, sets, tile_rays=TILE, pipeline_depth=2)
    # a kill aimed at every host fires on whichever host served
    eng.schedule_host_events([HostEvent("kill", 0, at_dispatch=3),
                              HostEvent("kill", 1, at_dispatch=3)])
    results = _run(eng, _requests(n=4))
    assert eng.stats["host_kills"] >= 1
    # with ALL hosts dead, the remaining submits terminate, never hang
    assert eng.pending == 0 and eng.in_flight_tiles == 0
    assert all(r.status in STATUSES for r in results.values())


def test_failover_hook_recovers_on_other_host(setup):
    cfg, sets, _ = setup
    reqs = _requests(n=2)
    clean = _clean(cfg, sets, reqs)
    plan = FaultPlan(FaultConfig(seed=1, dispatch_error_rate=0.4))
    eng = _cluster(cfg, sets, tile_rays=TILE, faults=plan)
    results = _run(eng, reqs)
    assert eng.stats["dispatch_errors"] > 0
    # a failed tile was served by the OTHER host instead of falling
    # through to the local retry ladder
    assert eng.stats["cross_host_redispatches"] >= 1
    for rid, res in results.items():
        assert res.status == "ok"
        np.testing.assert_array_equal(res.image, clean[rid].image)


# ------------------------------------------------------------ quarantine ---
def _flaky_loader(cfg, sets, failing):
    """A loader that raises while ``failing["on"]`` is set."""
    load = _loader(cfg, sets)

    def flaky(sid):
        if failing["on"]:
            raise RuntimeError("host-local checkpoint store down")
        return load(sid)
    return flaky


def test_quarantine_is_per_host_and_probes_recover(setup):
    cfg, sets, _ = setup
    failing = {"on": True}
    eng = ClusterEngine(
        [SceneCache(_flaky_loader(cfg, sets, failing), capacity_mb=256.0,
                    fail_backoff=0),
         SceneCache(_loader(cfg, sets), capacity_mb=256.0)],
        tile_rays=TILE, max_load_failures=1, quarantine_probe_tiles=1)
    # affinity steers placement at host 0 first: scene0 fails there, is
    # quarantined on host 0 and served from host 1
    eng.scheduler._affinity["scene0"] = 0
    res = _run(eng, [RenderRequest(scene_id="scene0", hw=16)])
    assert all(r.status == "ok" for r in res.values())
    assert eng.stats["quarantines"] >= 1
    assert (0, "scene0") in eng.scheduler._quarantine
    assert eng.pool.get(0).cache.failing_scenes() == ["scene0"]
    # host 0 still failing: the countdown expires, the probe fails and
    # re-arms the window (host 1 draining makes the scheduler look at 0)
    eng.pool.get(1).state = "draining"
    _run(eng, [RenderRequest(scene_id="scene0", hw=8)])
    assert eng.stats["quarantine_probes"] >= 1
    assert (0, "scene0") in eng.scheduler._quarantine
    # the store comes back: the next probe succeeds and lifts it
    failing["on"] = False
    res = _run(eng, [RenderRequest(scene_id="scene0", hw=8)])
    assert all(r.status == "ok" for r in res.values())
    assert eng.stats["quarantine_recoveries"] >= 1
    assert (0, "scene0") not in eng.scheduler._quarantine
    assert eng.pool.get(0).cache.failing_scenes() == []


def test_scene_dead_only_when_every_host_quarantined(setup):
    cfg, sets, _ = setup
    failing = {"on": True}
    eng = ClusterEngine(
        [SceneCache(_flaky_loader(cfg, sets, failing), capacity_mb=256.0,
                    fail_backoff=0) for _ in range(2)],
        tile_rays=TILE, max_load_failures=1)
    rid = eng.submit(RenderRequest(scene_id="scene0", hw=8))
    eng.drain()
    res = eng.take(rid)
    assert res.status == "rejected"
    assert "every serving host" in res.error
    # the pool itself is fine: a loadable scene still serves
    failing["on"] = False
    res2 = _run(eng, [RenderRequest(scene_id="scene1", hw=8)])
    assert all(r.status == "ok" for r in res2.values())


# -------------------------------------------------------------- admission --
def test_aggregate_admission_uses_prior_and_pool_health(setup):
    cfg, sets, _ = setup
    # a cold pool with a service prior predicts delay from the prior and
    # rejects an unmeetable deadline before any EWMA exists
    eng = _cluster(cfg, sets, tile_rays=TILE, tile_service_prior_s=10.0)
    eng.submit(RenderRequest(scene_id="scene0", hw=16))       # backlog
    rid = eng.submit(RenderRequest(scene_id="scene0", hw=8, deadline_s=0.5))
    res = eng.take(rid)
    assert res.status == "rejected" and "admission control" in res.error
    eng.drain()
    # a suspect host counts half: the same pool predicts a longer wait
    full = eng.scheduler._estimated_queueing_s()
    eng.pool.get(1).state = "suspect"
    assert eng.scheduler._estimated_queueing_s() >= full
    # no placeable host: infinite predicted delay
    for h in eng.pool:
        h.state = "dead"
    assert eng.scheduler._estimated_queueing_s() == float("inf")
    # a cold pool without a prior: no estimate, admit
    eng2 = _cluster(cfg, sets, tile_rays=TILE)
    assert eng2.scheduler._estimated_queueing_s() is None


# ---------------------------------------------------------- drain/rejoin ---
def test_drain_migrates_affinity_and_rejoin_restores(setup):
    cfg, sets, _ = setup
    eng = _cluster(cfg, sets, tile_rays=TILE)
    _run(eng, [RenderRequest(scene_id="scene0", hw=8)])
    served = [h for h in eng.pool if "scene0" in h.cache]
    assert len(served) == 1
    src = served[0]
    other = eng.pool.get(1 - src.id)
    eng.schedule_host_events([HostEvent("drain", src.id)])
    eng.step()
    assert src.state == "draining" and not src.placeable
    assert eng.stats["host_drains"] == 1
    # residency handed off: affinity points at the live host and the
    # drained host's unpinned weights are gone
    assert eng.stats["affinity_migrations"] >= 1
    assert eng.scheduler._affinity["scene0"] == other.id
    assert "scene0" not in src.cache
    res = _run(eng, [RenderRequest(scene_id="scene0", hw=8)])
    assert all(r.status == "ok" for r in res.values())
    assert "scene0" in other.cache
    eng.schedule_host_events([HostEvent("rejoin", src.id)])
    eng.step()
    assert src.state == "healthy" and src.placeable
    assert eng.stats["host_rejoins"] == 1


# ------------------------------------------------------ heartbeat / hang ---
def test_hung_host_is_killed_and_work_recovered(setup):
    cfg, sets, _ = setup
    reqs = [RenderRequest(scene_id="scene0", hw=16)]
    clean = _clean(cfg, sets, reqs)
    eng = _cluster(cfg, sets, tile_rays=TILE, pipeline_depth=2,
                   hang_kill_steps=5)
    rid = eng.submit(reqs[0])
    hung = None
    for _ in range(200):
        eng.step()
        busy = [h for h in eng.pool if h.executor.in_flight > 0]
        if busy:
            hung = busy[0]
            break
    assert hung is not None
    eng.schedule_host_events([HostEvent("hang", hung.id)])
    eng.drain()            # the clockless hang_kill_steps fallback fires
    assert eng.stats["heartbeat_timeouts"] >= 1
    assert hung.state == "dead"
    assert eng.stats["requeued_tiles"] >= 1
    res = eng.take(rid)
    assert res.status == "ok"
    np.testing.assert_array_equal(res.image, clean[rid].image)


def test_stale_heartbeat_marks_suspect_then_kills(setup):
    """Without a hang: a host with tiles in flight and no beat for the
    timeout turns suspect, and past twice the timeout it is killed."""
    cfg, sets, _ = setup
    clk = _StepClock()
    eng = _cluster(cfg, sets, tile_rays=TILE, pipeline_depth=3, clock=clk)
    eng.submit(RenderRequest(scene_id="scene0", hw=16))
    eng.step()
    h = next(h for h in eng.pool if h.executor.in_flight)
    eng._health_check(h.last_beat + 0.6)
    assert h.state == "suspect" and eng.stats["heartbeat_timeouts"] == 0
    eng._health_check(h.last_beat + 1.1)
    assert h.state == "dead" and eng.stats["heartbeat_timeouts"] == 1
    assert eng.stats["requeued_tiles"] >= 1


def test_slow_host_flagged_suspect_not_killed(setup):
    cfg, sets, _ = setup
    eng = _cluster(cfg, sets, tile_rays=TILE, straggler_mitigation=True)
    for _ in range(10):
        eng.monitor.record_host_step(0, 0.01)
        eng.monitor.record_host_step(1, 1.0)
    eng._health_check(eng._clock())
    h0, h1 = eng.pool.get(0), eng.pool.get(1)
    assert h1.state == "suspect" and h0.state == "healthy"
    assert eng.stats["slow_host_flags"] == 1
    assert h1.placeable                       # deprioritized, still served
    assert eng.scheduler._place("scene0").id == 0
    # recovery: the EWMA converges back and the flag clears
    for _ in range(500):
        eng.monitor.record_host_step(1, 0.01)
    eng._health_check(eng._clock())
    assert h1.state == "healthy"


# ------------------------------------------------------------ robustness ---
def test_cluster_stats_and_robustness_schema(setup):
    cfg, sets, _ = setup
    eng = _cluster(cfg, sets, tile_rays=TILE)
    _run(eng, _requests(n=2))
    cs = eng.cluster_stats()
    assert cs["n_hosts"] == 2 and set(cs["hosts"]) == {0, 1}
    for h in cs["hosts"].values():
        assert h["state"] in HOST_STATES
    assert eng.robustness()["cluster"]["host_kills"] == 0
    ref = JaxClusterEngine([JaxSceneCache(lambda sid: None)
                            for _ in range(2)])
    assert set(cs) == set(ref.cluster_stats())
    assert set(cs["hosts"][0]) == set(ref.cluster_stats()["hosts"][0])


def test_fuzz_cluster_interleaving_always_terminates(setup):
    cfg, sets, _ = setup
    rng = np.random.RandomState(11)
    plan = FaultPlan(FaultConfig.cluster_chaos(seed=4))
    eng = ClusterEngine(
        [SceneCache(plan.wrap_loader(_loader(cfg, sets)), capacity_mb=256.0)
         for _ in range(3)],
        tile_rays=32, faults=plan, max_queue=16, aging_tiles=4,
        pipeline_depth=2, max_load_failures=2, quarantine_probe_tiles=2)
    eng.schedule_host_events([
        HostEvent("kill", 2, at_dispatch=10),
        HostEvent("drain", 1, at_dispatch=20),
        HostEvent("rejoin", 1, at_dispatch=30),
        HostEvent("slow", 0, at_dispatch=5, extra_s=0.001)])
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
    assert steps < 20000                       # terminated, not capped
    assert eng.pending == 0 and eng.in_flight_tiles == 0
    assert not eng.scheduler._requeue
    results = dict(taken)
    results.update(eng.completed)
    # every submitted request reached EXACTLY ONE terminal status
    assert set(results) == submitted
    assert eng.stats["requests_completed"] == len(submitted)
    for res in results.values():
        assert res.status in STATUSES
        if res.delivered:
            assert np.isfinite(res.image).all()


# ----------------------------------------------------- reference parity ----
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_draw_host_event_matches_reference(seed):
    ours = FaultPlan(FaultConfig(seed=seed, host_kill_rate=0.1,
                                 host_slow_rate=0.3, host_slow_extra_s=0.07))
    ref = JaxFaultPlan(JaxFaultConfig(seed=seed, host_kill_rate=0.1,
                                      host_slow_rate=0.3,
                                      host_slow_extra_s=0.07))
    order = [h for _ in range(20) for h in (0, 2, 1, 1, 0)]
    assert [ours.draw_host_event(h) for h in order] == \
        [ref.draw_host_event(h) for h in order]
    assert ours.summary() == ref.summary()
    chaos = FaultPlan(FaultConfig.cluster_chaos(seed))
    jchaos = JaxFaultPlan(JaxFaultConfig.cluster_chaos(seed))
    assert [chaos.draw_host_event(h % 3) for h in range(60)] == \
        [jchaos.draw_host_event(h % 3) for h in range(60)]
    assert [chaos.draw_dispatch() for _ in range(30)] == \
        [jchaos.draw_dispatch() for _ in range(30)]


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
def test_overload_host_events_matches_reference(n_hosts):
    for seed in range(4):
        ours = loadgen.overload_host_events(n_hosts, 2.0, seed=seed)
        if n_hosts == 1:
            # the reference raises here (numpy's randint(0)); its docstring
            # promises the slow event alone, which the port returns
            with pytest.raises(ValueError):
                jax_loadgen.overload_host_events(1, 2.0, seed=seed)
            assert [(e.kind, e.host, e.at_s) for e in ours] == \
                [("slow", 0, 0.3)]
            continue
        ref = jax_loadgen.overload_host_events(n_hosts, 2.0, seed=seed)
        assert [vars(e) for e in ours] == [vars(e) for e in ref]
        assert [e.kind for e in ours] == ["slow", "kill"]
        assert ours[0].host != ours[1].host
    with pytest.raises(ValueError):
        loadgen.overload_host_events(0, 1.0)


class _StepClock:
    """A clock that moves only when told: both packages' engines read the
    same times in a run that steps the same way."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _step_clocked(engine, clk, dt=1e-3):
    """Advance ``clk`` by ``dt`` before every engine step; injected
    stalls pay nothing (the sleep is a no-op)."""
    step = engine.step

    def stepped():
        clk.advance(dt)
        return step()
    engine.step = stepped
    for h in engine.pool:
        h.executor._sleep = lambda s: None
    return engine


@pytest.mark.parametrize("kill_host,requeued", [(0, 0), (1, 1)])
def test_cluster_run_matches_reference_engine(setup, kill_host, requeued):
    """The same closed-loop trace through the reference's cluster and the
    port's, two hosts on bridged weights (the plain path), under
    ``cluster_chaos(0)`` and a kill at dispatch 3, each on its own step
    clock: equal per-request statuses and clock-free counters, images
    within 1e-3. Host 0 holds no tile at that point (the kill re-queues
    nothing), host 1 one."""
    cfg, sets, jax_sets = setup
    trace = loadgen.poisson_trace(8, ["scene0", "scene1", "scene2"],
                                  rate_rps=100.0, hw_choices=(8, 12), seed=3)
    jtrace = jax_loadgen.poisson_trace(8, ["scene0", "scene1", "scene2"],
                                       rate_rps=100.0, hw_choices=(8, 12),
                                       seed=3)
    kw = dict(tile_rays=TILE, pipeline_depth=2)
    plan = FaultPlan(FaultConfig.cluster_chaos(0))
    clk = _StepClock()
    eng = _step_clocked(ClusterEngine(
        [SceneCache(plan.wrap_loader(
            lambda sid: PackedPlcore(cfg, sets[sid], device="cpu")),
            capacity_mb=256.0) for _ in range(2)],
        faults=plan, clock=clk, **kw), clk)
    jplan = JaxFaultPlan(JaxFaultConfig.cluster_chaos(0))
    jclk = _StepClock()
    jeng = _step_clocked(JaxClusterEngine(
        [JaxSceneCache(jplan.wrap_loader(
            lambda sid: JaxPackedPlcore(jax_tiny(), jax_sets[sid])),
            capacity_mb=256.0) for _ in range(2)],
        faults=jplan, clock=jclk, **kw), jclk)
    rep = loadgen.run_trace(eng, trace, mode="closed", concurrency=3,
                            clock=clk,
                            host_events=[HostEvent("kill", kill_host,
                                                   at_dispatch=3)])
    jrep = jax_loadgen.run_trace(
        jeng, jtrace, mode="closed", concurrency=3, clock=jclk,
        host_events=[JaxHostEvent("kill", kill_host, at_dispatch=3)])
    assert rep["requests_completed"] == jrep["requests_completed"] == 8
    for key in ("dispatches", "host_kills", "requeued_tiles",
                "cross_host_redispatches", "host_slow_events",
                "affinity_migrations", "failovers", "quarantines",
                "tile_retries", "oracle_fallbacks", "dispatch_errors"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["host_kills"] == 1
    assert eng.stats["requeued_tiles"] == requeued
    assert plan.summary() == jplan.summary()
    for rid in range(8):
        ours, ref = eng.completed[rid], jeng.completed[rid]
        assert ours.status == ref.status, rid
        if ours.status in ("ok", "degraded"):
            np.testing.assert_allclose(ours.image, np.asarray(ref.image),
                                       rtol=0, atol=1e-3)


# ------------------------------------------------------ serve, trace, metrics
def _serve_argv(*extra):
    return ["--mode", "engine", "--device", "cpu", "--kernel",
            "--fuse-two-pass", "--hw-mix", "8,16", "--tile-rays", "64",
            "--loop", "closed", "--pipeline-depth", "2", *extra]


def test_serve_hosts_kill_check_passes():
    rep = serve.main(_serve_argv("--hosts", "2", "--host-kill", "1:@6",
                                 "--check"))
    assert rep["hosts"] == 2 and rep["host_events"] == ["kill:1"]
    cl = rep["cluster"]
    assert cl["host_kills"] == 1 and cl["cross_host_redispatches"] >= 1
    assert cl["hosts"][1]["state"] == "dead"
    assert rep["check_compared"]["single_host"] == 12
    assert rep["robustness"]["goodput"] == 1.0


@pytest.mark.parametrize("extra,msg", [
    (["--host-kill", "1:@6"], "need --hosts >= 2"),
    (["--hosts", "2", "--host-kill", "1"], "expected HOST:AT_S"),
    (["--hosts", "2", "--host-slow", "x:@3"], "expected HOST:AT_S"),
    (["--hosts", "2", "--host-kill", "2:@3"], "not in the pool"),
    (["--hosts", "0"], "--hosts must be >= 1"),
    (["--hosts", "2", "--adaptive-sampling"], "--hosts > 1")])
def test_serve_host_flag_errors(extra, msg):
    with pytest.raises(SystemExit, match=msg):
        serve.main(_serve_argv(*extra))


def test_run_trace_refuses_host_events_on_one_host(setup):
    cfg, sets, _ = setup
    eng = RenderEngine(SceneCache(_loader(cfg, sets)), tile_rays=TILE)
    trace = loadgen.poisson_trace(2, ["scene0"], rate_rps=10.0, seed=0)
    with pytest.raises(ValueError, match="requires a ClusterEngine"):
        loadgen.run_trace(eng, trace, mode="closed",
                          host_events=[HostEvent("kill", 0)])


def test_span_chain_complete_under_host_kill(setup):
    cfg, sets, _ = setup
    tr = SpanTracer()
    eng = _cluster(cfg, sets, tile_rays=TILE, pipeline_depth=2, tracer=tr)
    eng.schedule_host_events([HostEvent("kill", 0, at_dispatch=3)])
    rids = [eng.submit(r) for r in
            [RenderRequest(scene_id=f"scene{i % 2}", hw=12, theta=30.0 * i)
             for i in range(6)]]
    eng.drain()
    for rid in rids:
        assert eng.take(rid).status in ("ok", "failed", "degraded")
    out = validate_trace(tr)
    assert out["ok"], out["errors"]
    assert out["dispatched_tiles"] >= 1
    names = {s.name for s in tr.spans()}
    assert "host.kill" in names
    # re-queued tiles still ended terminal (scatter after the redispatch)
    if eng.stats["requeued_tiles"]:
        assert "tile.requeue" in names or "tile.abandon" in names
    # cache events carry their host
    hosts = {s.attrs.get("host") for s in tr.spans()
             if s.name.startswith("cache.")}
    assert hosts <= {0, 1} and hosts


def test_host_families_in_prometheus_text(setup):
    cfg, sets, _ = setup
    reg = MetricsRegistry()
    eng = _cluster(cfg, sets, tile_rays=TILE, pipeline_depth=2,
                   registry=reg)
    eng.schedule_host_events([HostEvent("kill", 1, at_dispatch=4)])
    _run(eng, _requests(n=4))
    lines = prometheus_text(reg).splitlines()
    for family, kind in (("engine_host_dispatches_total", "counter"),
                         ("engine_host_tile_service_seconds", "histogram"),
                         ("engine_host_service_ewma_seconds", "gauge"),
                         ("engine_host_state", "gauge")):
        assert f"# TYPE {family} {kind}" in lines, family
    per_host = {h.id: h.dispatches for h in eng.pool}
    for host, n in per_host.items():
        if n:
            assert f'engine_host_dispatches_total{{host="{host}"}} {n}' \
                in lines
    assert 'engine_host_state{host="1"} 3' in lines
    assert 'engine_host_state{host="0"} 0' in lines
    assert any(l.startswith('engine_host_tile_service_seconds_count'
                            '{host="0"}') for l in lines)
    # the cluster's stats block exports as counters too
    assert any(l.startswith("engine_host_kills_total 1") for l in lines)
    json.dumps(eng.robustness())
