"""The port's serving engine with adaptive sampling (ASDR) on the CPU: the
reference engine's adaptive invariants re-proved with the port's engine
(tiny config, the kernel wrappers' plain versions, the sigma head biased
by -0.5 so the scenes hold empty space), the scene cache's aux residents,
and the adaptive engine's images against the reference's adaptive engine
on the same weights."""
import jax
import numpy as np
import pytest

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core.pipeline import PackedPlcore as JaxPackedPlcore
from repro.core.plcore import plcore_decls as jax_decls
from repro.models.params import init_params as jax_init
from repro.serving import RenderEngine as JaxRenderEngine
from repro.serving import RenderRequest as JaxRequest
from repro.serving import SceneCache as JaxSceneCache

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.kernels import ops
from repro_torch.serving import RenderEngine, RenderRequest, SceneCache

FUSED = dict(use_kernel=True, fuse_two_pass=True)
ADAPTIVE = dict(adaptive_sampling=True, memo_mb=8.0, adaptive_grid_res=16,
                adaptive_probe_hw=6)


@pytest.fixture(scope="module")
def scene():
    """One biased scene drawn by the reference's initializer, as the
    reference's weights and as tensors."""
    params = jax_init(jax_decls(jax_tiny()), jax.random.PRNGKey(0),
                      "float32")
    params = jax.tree.map(np.asarray, params)
    for n in params:
        params[n]["sigma"]["b"] = params[n]["sigma"]["b"] - 0.5
    return params, bridge.to_torch(params)


def _port_engine(tparams, **kw):
    pp = PackedPlcore(tiny(), tparams, device="cpu", **FUSED)
    cache = SceneCache(lambda sid: pp, capacity_mb=64.0)
    return RenderEngine(cache, tile_rays=kw.pop("tile_rays", 64), **kw)


def _requests(seed, n=2, hw=12):
    rng = np.random.default_rng(seed)
    return [RenderRequest("s0", hw=hw, theta=float(rng.uniform(0, 360)),
                          phi=float(rng.uniform(-35, -15)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_bucket_purity(scene, seed):
    """Every adaptive tile is budget-pure: all its rays classify into the
    class whose n_fine it renders at, and a dead-bucket tile carries only
    hinted-dead rays."""
    eng = _port_engine(scene[1], **ADAPTIVE)
    seen = []
    orig = eng.adaptive.account
    eng.adaptive.account = (
        lambda tile, info, stats: (seen.append((tile, info)),
                                   orig(tile, info, stats))[1])
    for r in _requests(seed):
        eng.submit(r)
    eng.drain()
    assert seen and all(eng.completed[i].status == "ok" for i in range(2))
    ar = eng.adaptive.renderer("s0", eng.cache.get("s0"))
    kinds = set()
    for tile, info in seen:
        cls = ar.classify_rays(tile.rays_o, tile.rays_d)
        hint = ar.dead_hint(tile.rays_o, tile.rays_d)
        if tile.dead_bucket:
            assert hint.all(), "dead-bucket tile holds a non-hinted ray"
            kinds.add("dead")
        else:
            assert not hint.any(), "hinted-dead ray leaked into a class tile"
            assert (cls == ar.budgets.index(tile.budget)).all()
            kinds.add(tile.budget)
        # shrunken tiles are powers of two, at least 32 rays
        n = tile.rays_o.shape[0]
        assert n == 64 or (n >= 32 and n & (n - 1) == 0), n
    assert "dead" in kinds and len(kinds) >= 2


def test_adaptive_engine_matches_reference_engine(scene):
    """The same requests through the reference's adaptive engine and the
    port's on the same weights: the same tiles, dead rows and memo
    traffic, pixels within 5e-3 (kernel path against kernel path)."""
    jparams, tparams = scene
    reqs = _requests(5, n=3, hw=12)
    jeng = JaxRenderEngine(
        JaxSceneCache(lambda sid: JaxPackedPlcore(jax_tiny(), jparams,
                                                  **FUSED)),
        tile_rays=64, **ADAPTIVE)
    jrids = [jeng.submit(JaxRequest(r.scene_id, hw=r.hw, theta=r.theta,
                                    phi=r.phi)) for r in reqs]
    jeng.drain()
    eng = _port_engine(tparams, **ADAPTIVE)
    rids = [eng.submit(r) for r in reqs]
    eng.drain()
    for key in ("dispatches", "padded_rays", "rays_rendered",
                "adaptive_tiles", "full_dead_tiles", "dead_rays",
                "skipped_fine_samples", "memo_hits", "memo_misses",
                "memo_topup_voxels"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["dead_rays"] > 0
    for rid, jrid in zip(rids, jrids):
        assert eng.completed[rid].status == "ok"
        np.testing.assert_allclose(eng.completed[rid].image,
                                   np.asarray(jeng.completed[jrid].image),
                                   rtol=0, atol=5e-3)
    rep = eng.sampling_report()
    assert rep["scenes"]["s0"]["host_ms_per_tile"] > 0
    assert {k for k in jeng.sampling_report()} <= set(rep)


def test_adaptive_engine_depths_bit_identical_and_launches(scene):
    """Depth 2 equals depth 1 bit for bit; K2 runs once per adaptive tile
    that was not fully dead."""
    imgs = []
    for depth in (1, 2):
        eng = _port_engine(scene[1], pipeline_depth=depth, **ADAPTIVE)
        before = ops.dispatch_count()
        rids = [eng.submit(r) for r in _requests(7, n=3)]
        eng.drain()
        st = eng.stats
        assert ops.dispatch_count() - before == \
            st["adaptive_tiles"] - st["full_dead_tiles"]
        assert st["full_dead_tiles"] >= 1
        imgs.append([eng.completed[r].image for r in rids])
    for a, b in zip(*imgs):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ SceneCache + aux ----
class _DummyAux:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def _cache(tparams, capacity_mb):
    return SceneCache(lambda sid: PackedPlcore(tiny(), tparams, device="cpu"),
                      capacity_mb=capacity_mb)


def test_ensure_aux_requires_resident_scene(scene):
    cache = _cache(scene[1], 64.0)
    with pytest.raises(KeyError, match="load it before"):
        cache.ensure_aux("s0", lambda pp: _DummyAux(1024))


def test_ensure_aux_builds_once_and_counts(scene):
    cache = _cache(scene[1], 64.0)
    cache.get("s0")
    base = cache.resident_bytes
    calls = []
    builder = lambda pp: (calls.append(pp), _DummyAux(1 << 20))[1]  # noqa
    a1 = cache.ensure_aux("s0", builder)
    a2 = cache.ensure_aux("s0", builder)
    assert a1 is a2 and len(calls) == 1
    assert isinstance(calls[0], PackedPlcore)
    assert cache.aux_bytes == 1 << 20
    assert cache.resident_bytes == base + (1 << 20)
    a1.nbytes = 3 << 20                       # the memo grew: read live
    assert cache.resident_bytes == base + (3 << 20)
    st = cache.stats()
    assert st["aux_scenes"] == 1 and st["aux_mb"] == 3.0
    cache.pin("s0")
    assert not cache.discard("s0")            # pinned: refused
    cache.unpin("s0")
    assert cache.discard("s0")
    assert cache.aux("s0") is None and cache.aux_bytes == 0
    assert "s0" not in cache and not cache.discard("s0")


def test_eviction_drops_aux_and_pins_protect(scene):
    cache = _cache(scene[1], 2.0)
    cache.get("s0")
    cache.ensure_aux("s0", lambda pp: _DummyAux(int(1.5 * 2 ** 20)))
    cache.pin("s0")
    cache.get("s1")                           # over capacity, s0 pinned
    assert "s0" in cache and cache.aux("s0") is not None
    cache.unpin("s0")
    cache.get("s2")                           # now s0 is evictable
    assert "s0" not in cache and cache.aux("s0") is None
    assert cache.stats()["aux_scenes"] == 0


def test_reload_after_eviction_rebuilds_the_renderer(scene):
    """An evicted scene's aux leaves with it; the reload probes afresh and
    the engine's renderer follows the new resident."""
    tparams = scene[1]
    cache = SceneCache(lambda sid: PackedPlcore(tiny(), tparams, device="cpu",
                                                **FUSED), capacity_mb=64.0)
    eng = RenderEngine(cache, tile_rays=64, **ADAPTIVE)
    eng.submit(RenderRequest("s0", hw=8))
    eng.drain()
    ar0 = eng.adaptive.renderer("s0", cache.get("s0"))
    assert cache.aux("s0") is ar0.aux and cache.stats()["aux_mb"] > 0
    assert cache.discard("s0") and cache.aux("s0") is None
    ar1 = eng.adaptive.renderer("s0", cache.get("s0"))
    assert ar1 is not ar0 and cache.aux("s0") is ar1.aux
