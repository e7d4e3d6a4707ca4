"""The port's ASDR (adaptive sample budgets + trunk memo) against the
reference's, on the same weights (the tiny config, the sigma head biased by
-0.5 so the scene holds empty space) and the same inputs.

* The numpy bookkeeping (budget ladder, ``SampleStats``, ``TrunkMemo``)
  gives the reference's outputs and counters bit for bit.
* ``trunk_rows`` and the calibration grids agree to 1e-5 (plain f32 tensor
  code on both sides; the camera rays differ from the reference's in the
  last ulp, ``test_torch_pipeline``), with identical ``probed`` masks.
* ``AdaptiveRenderer`` fed the reference's ``SampleStats`` classifies
  identically: the same dead masks, and pixels within 5e-3 (kernel
  against kernel, the parity matrix's tolerance for kernel paths).
* K2 at a budget with an ``alive`` mask (``render_tile(budget=, alive=)``)
  agrees with the reference's within 5e-3.

The reference renders through its own fused-kernel path on the CPU, as
``tests/test_adaptive.py`` runs it.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core import pipeline as jp
from repro.core import rmcm as jr
from repro.core import sampling as js
from repro.core.plcore import plcore_decls
from repro.models.params import init_params

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core import pipeline as P
from repro_torch.core import sampling as S
from repro_torch.data import rays as R
from repro_torch.kernels import ops
from repro_torch.serving import RenderEngine, SceneCache

BIAS = -0.5
GRID, PROBE_HW, MEMO_MB = 16, 6, 8.0


def _biased(params, bias):
    out = {n: dict(p) for n, p in params.items()}
    for n in out:
        out[n]["sigma"] = {**out[n]["sigma"],
                           "b": out[n]["sigma"]["b"] + bias}
    return out


def _to_t(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def nets():
    """Reference and port PackedPlcores on the same biased weights, f32
    and RMCM."""
    params = _biased(init_params(plcore_decls(jax_tiny()),
                                 jax.random.PRNGKey(0), "float32"), BIAS)
    quant = {n: jr.quantize_tree(params[n]) for n in ("coarse", "fine")}
    fused = dict(use_kernel=True, fuse_two_pass=True)
    out = {}
    for q in (False, True):
        jq = quant if q else None
        out[q] = (jp.PackedPlcore(jax_tiny(), params, quant=jq, **fused),
                  P.PackedPlcore(tiny(), _to_t(params),
                                 quant=None if jq is None else _to_t(jq),
                                 device="cpu", **fused))
    return out


@pytest.fixture(scope="module")
def auxes(nets):
    jpp, tpp = nets[False]
    kw = dict(grid_res=GRID, probe_hw=PROBE_HW, memo_mb=MEMO_MB)
    return jp.build_scene_aux(jpp, **kw), P.build_scene_aux(tpp, **kw)


def _port_stats(st):
    """A port SampleStats holding the reference's arrays."""
    return S.SampleStats(lo=st.lo.copy(), vsize=st.vsize,
                         grid=st.grid.copy(), edges=st.edges.copy(),
                         probed=st.probed.copy(), empty_tau=st.empty_tau)


def _twin_renderers(nets, auxes):
    """Fresh reference and port renderers on the reference's stats, the
    port's memo warmed at the same voxels."""
    jpp, tpp = nets[False]
    jaux = auxes[0]
    jaux = js.SceneAux(stats=jaux.stats, memo=js.TrunkMemo(MEMO_MB),
                       t_row=jaux.t_row)
    g = jaux.stats.grid.reshape(-1)
    p = jaux.stats.probed.reshape(-1)
    empty = np.nonzero(p & (g < jaux.stats.empty_tau))[0]
    row_b = (1 + jpp.cfg.trunk_width) * 4 + 48
    empty = empty[:jaux.memo.capacity_bytes // row_b]
    jaux.memo.insert("c", empty,
                     jp.trunk_rows(jpp, jaux.stats.voxel_centers(empty)))
    taux = S.SceneAux(stats=_port_stats(jaux.stats),
                      memo=S.TrunkMemo(MEMO_MB), t_row=jaux.t_row.copy())
    P.warm_trunk_memo(tpp, taux)
    assert len(taux.memo) == len(jaux.memo) == empty.size
    return jp.AdaptiveRenderer(jpp, jaux), P.AdaptiveRenderer(tpp, taux)


def _view(theta, hw=16, phi=-25.0):
    o, d = R.camera_rays(R.pose_spherical(theta, phi, 4.0), hw, hw, 0.9 * hw)
    return o.reshape(-1, 3).numpy(), d.reshape(-1, 3).numpy()


# ------------------------------------------------------- host bookkeeping ---
def test_default_budget_classes_match_reference():
    for nf in (4, 8, 16, 32, 64, 128, 256):
        assert S.default_budget_classes(nf) == js.default_budget_classes(nf)
    assert S.default_budget_classes(128) == (8, 32, 64)


def _probe_cloud(seed):
    """48 rays x 8 samples split into an empty, a faint and a dense band
    along x (the reference test's cloud), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    n, m = 16, 8

    def band(x0, x1):
        pts = rng.uniform(-1.0, 1.0, (n, m, 3)).astype(np.float32)
        pts[..., 0] = rng.uniform(x0, x1, (n, m))
        return pts
    pts = np.concatenate([band(-1.0, -0.2), band(0.2, 0.55), band(0.65, 1.0)])
    sigma = np.concatenate([np.zeros((n, m), np.float32),
                            rng.uniform(0.02, 0.08, (n, m)).astype(np.float32),
                            rng.uniform(1.0, 9.0, (n, m)).astype(np.float32)])
    return pts, sigma


@pytest.mark.parametrize("grid_res,n_classes", [(8, 3), (12, 2), (16, 4),
                                                (8, 1)])
def test_sample_stats_match_reference_bit_for_bit(grid_res, n_classes):
    pts, sigma = _probe_cloud(grid_res + n_classes)
    kw = dict(grid_res=grid_res, n_classes=n_classes, empty_tau=1e-2)
    a, b = js.build_sample_stats(pts, sigma, **kw), \
        S.build_sample_stats(pts, sigma, **kw)
    for k in ("lo", "grid", "edges", "probed"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    assert a.vsize == b.vsize and a.nbytes == b.nbytes and a.res == b.res
    budgets = (4, 8, 16, 32)[:max(1, n_classes)]
    vox = b.voxel_ids(pts)
    np.testing.assert_array_equal(a.voxel_ids(pts), vox)
    np.testing.assert_array_equal(a.ray_scores(pts), b.ray_scores(pts))
    np.testing.assert_array_equal(a.classify(pts, budgets),
                                  b.classify(pts, budgets))
    np.testing.assert_array_equal(a.empty_mask(vox), b.empty_mask(vox))
    far = np.full((1, 4, 3), 50.0, np.float32)     # unprobed: never empty
    assert not b.empty_mask(b.voxel_ids(far)).any()
    ids = np.unique(vox)
    centers = b.voxel_centers(ids)
    np.testing.assert_array_equal(a.voxel_centers(ids), centers)
    np.testing.assert_array_equal(b.voxel_ids(centers), ids)


def _memo_script(mod):
    """One scripted sequence of memo operations on ``mod``'s TrunkMemo:
    growth, lookups, LRU refresh past half capacity, eviction, pins that
    block it, an unbalanced unpin, slot reuse and a second network.
    Returns every output and counter along the way."""
    rows = lambda ids, salt=0.0: (np.asarray(ids, np.float32)[:, None] * 10.0  # noqa: E731
                                  + np.arange(4, dtype=np.float32) + salt)
    m = mod.TrunkMemo(capacity_mb=240 / 2 ** 20)   # three 80-byte rows
    log = []

    def snap(tag, *outs):
        log.append((tag, [np.asarray(o).copy() for o in outs], m.stats(),
                    len(m), m.nbytes, m.pinned_rows))
    m.insert("c", np.array([3, 2000]), rows([3, 2000]))
    snap("insert", m.contains("c", np.array([3, 5, 2000, 99999])))
    snap("lookup", *m.lookup("c", np.array([3, 5, 2000])))
    m.insert("c", np.array([7]), rows([7]))
    snap("refresh", *m.lookup("c", np.array([3])))
    m.insert("c", np.array([8]), rows([8]))          # evicts the LRU (2000)
    snap("evict", *m.lookup("c", np.array([3, 7, 8, 2000])))
    m.pin("c", np.array([3, 7, 8]))
    m.insert("c", np.array([9]), rows([9], 0.5))     # all pinned: overshoot
    snap("pinned", *m.lookup("c", np.array([3, 7, 8, 9])))
    m.unpin("c", np.array([3, 3, 7, 8]))             # floors at zero
    m.insert("c", np.array([11]), rows([11], 0.25))  # evicts, reuses a slot
    snap("reuse", *m.lookup("c", np.array([3, 7, 8, 9, 11])))
    m.insert("f", np.array([5]), rows([5], 9.0))
    snap("nets", *m.lookup("f", np.array([5, 6])), *m.lookup("c", [5]))
    return log


def test_trunk_memo_scripted_sequence_matches_reference():
    ref, got = _memo_script(js), _memo_script(S)
    assert len(ref) == len(got)
    for (tag, a_out, a_st, *a_rest), (_, b_out, b_st, *b_rest) in zip(ref,
                                                                      got):
        assert a_st == b_st and a_rest == b_rest, tag
        for x, y in zip(a_out, b_out):
            assert x.dtype == y.dtype, tag
            np.testing.assert_array_equal(x, y, tag)
    assert got[3][2]["evictions"] >= 1 and got[4][3] > 0


# --------------------------------------------------------- device side ------
@pytest.mark.parametrize("quantized", [False, True])
def test_trunk_rows_match_reference(nets, quantized):
    jpp, tpp = nets[quantized]
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    want = jp.trunk_rows(jpp, pts, chunk=128)
    got = P.trunk_rows(tpp, pts, chunk=128)
    assert got.shape == want.shape == (300, 1 + tpp.cfg.trunk_width)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_memo_rows_equal_fresh_trunk_rows(nets, auxes):
    """A row read from the memo equals ``trunk_rows`` of the same voxel
    centre bit for bit, whatever block it was computed in."""
    _, tpp = nets[False]
    taux = auxes[1]
    ids = np.nonzero(taux.memo._resident["c"])[0]
    assert ids.size > 10
    pick = ids[::max(1, ids.size // 37)][::-1]        # other blocks, order
    mask, rows = taux.memo.lookup("c", pick)
    assert mask.all()
    fresh = P.trunk_rows(tpp, taux.stats.voxel_centers(pick))
    np.testing.assert_array_equal(rows, fresh)


def test_build_scene_aux_matches_reference(auxes):
    ja, ta = auxes
    np.testing.assert_array_equal(ja.t_row, ta.t_row)
    np.testing.assert_array_equal(ja.stats.probed, ta.stats.probed)
    np.testing.assert_allclose(ta.stats.grid, ja.stats.grid, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ta.stats.lo, ja.stats.lo, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ta.stats.edges, ja.stats.edges, rtol=0,
                               atol=1e-5)
    assert abs(ta.stats.vsize - ja.stats.vsize) < 1e-5
    assert 0 < len(ta.memo) == len(ja.memo)
    assert ja.stats.probed.any() and (ja.stats.grid[ja.stats.probed]
                                      < 1e-2).any()


@pytest.mark.parametrize("budget", [4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_k2_at_a_budget_matches_reference(nets, budget, masked):
    """``render_tile(budget=, alive=)``: K2's plain version at n_fine =
    budget against the reference's kernel path at the same budget."""
    for q in (False, True):
        jpp, tpp = nets[q]
        o, d = _view(20.0)
        alive = (np.arange(o.shape[0]) % 3 != 0).astype(np.float32)
        kw = ({"alive": alive} if masked else {})
        want = np.asarray(jpp.render_tile(
            jax.numpy.asarray(o), jax.numpy.asarray(d), budget=budget,
            **({"alive": jax.numpy.asarray(alive)} if masked else {})))
        got = tpp.render_tile(o, d, budget=budget,
                              **{k: torch.from_numpy(v)
                                 for k, v in kw.items()}).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
        handle, _ = tpp.dispatch_tile(o, d, budget=budget,
                                      alive=alive if masked else None)
        np.testing.assert_array_equal(handle.result(), got)
        full = tpp.render_tile(o, d).numpy()
        assert np.abs(got - full).max() > 0     # the budget changed pixels


def test_adaptive_render_tile_matches_reference(nets, auxes):
    jar, tar = _twin_renderers(nets, auxes)
    o, d = _view(20.0)
    hint = tar.dead_hint(o, d)
    np.testing.assert_array_equal(hint, jar.dead_hint(o, d))
    cls = tar.classify_rays(o, d)
    np.testing.assert_array_equal(cls, jar.classify_rays(o, d))
    assert hint.sum() >= 8 and (~hint).sum() >= 8
    # a hint-pure tile, a class tile, and a mixed tile, in that order on
    # both sides (the memo's state walks identically)
    tiles = [np.nonzero(hint)[0][:48],
             np.nonzero(~hint & (cls == cls[~hint][0]))[0][:32],
             np.arange(0, o.shape[0], 5)]
    for i, idx in enumerate(tiles):
        b = tar.budgets[0] if i == 0 else tar.budgets[int(cls[idx[0]])]
        jdead, _, jsig, jfeat = jar.dead_and_rows(o[idx], d[idx])
        tdead, vox, rows, inv = tar.dead_and_rows(o[idx], d[idx])
        np.testing.assert_array_equal(tdead, jdead)
        if tdead.any():   # only the dead rays' rows are gathered
            assert inv.shape == (int(tdead.sum()), vox.shape[1])
            np.testing.assert_allclose(rows[inv][..., 0], jsig[jdead],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(rows[inv][..., 1:], jfeat[jdead],
                                       rtol=0, atol=1e-5)
        jrgb, jinfo = jar.render_tile(o[idx], d[idx], budget=b)
        trgb, tinfo = tar.render_tile(o[idx], d[idx], budget=b)
        np.testing.assert_array_equal(tinfo["dead_mask"], jdead)
        for k in ("rays", "dead", "budget", "full_dead",
                  "skipped_fine_samples"):
            assert tinfo[k] == jinfo[k], k
        np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=0,
                                   atol=5e-3)
    assert tar.counters["dead_rays"] > 0
    rj, rt = jar.report(), tar.report()
    for k in ("tiles", "rays", "dead_rays", "full_dead_tiles",
              "skipped_fine_samples", "topup_voxels", "dead_ray_fraction",
              "budgets", "budget_tiles", "budget_rays", "memo"):
        assert rt[k] == rj[k], k


def test_adaptive_render_image_matches_reference(nets, auxes):
    jar, tar = _twin_renderers(nets, auxes)
    o, d = _view(200.0, hw=16, phi=-30.0)
    want = jar.render_image(o.reshape(16, 16, 3), d.reshape(16, 16, 3),
                            rays_per_tile=64)
    got, dead = tar.render_image(o.reshape(16, 16, 3), d.reshape(16, 16, 3),
                                 rays_per_tile=64, with_dead=True)
    assert got.shape == (16, 16, 3) and dead.shape == (16, 16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=5e-3)
    rj, rt = jar.report(), tar.report()
    assert rt["dead_rays"] == rj["dead_rays"] == int(dead.sum()) > 0
    for k in ("tiles", "full_dead_tiles", "budget_rays", "memo"):
        assert rt[k] == rj[k], k


def test_live_rays_equal_unmasked_budget_render(nets, auxes):
    """Every ray of ``render_image`` that did not render dead equals a
    ``render_tile(budget=)`` of the same rays without a mask, bit for bit
    (a ray's pixel does not depend on its tile-mates or the mask)."""
    _, tar = _twin_renderers(nets, auxes)
    o, d = _view(20.0)
    img, dead = tar.render_image(o, d, rays_per_tile=64, with_dead=True)
    cls = tar.classify_rays(o, d)
    live = 0
    for c, b in enumerate(tar.budgets):
        idx = np.nonzero((cls == c) & ~dead)[0]
        if idx.size:
            want = tar.pp.render_tile(o[idx], d[idx], budget=b).numpy()
            np.testing.assert_array_equal(img[idx], want)
            live += idx.size
    assert 0 < dead.sum() and live + dead.sum() == o.shape[0]


def test_full_dead_tile_is_exact_white_and_skips_k2(nets):
    """A scene whose probe finds only empty space: hinted tiles resolve
    fully dead, never reach K2, and are exactly white (relu(sigma <= 0)
    -> zero weights -> acc 0 -> 1.0)."""
    _, tpp = nets[False]
    params = _biased(bridge.to_numpy(tpp.params), -5.0)
    pp = P.PackedPlcore(tiny(), bridge.to_torch(params), device="cpu",
                        use_kernel=True, fuse_two_pass=True)
    aux = P.build_scene_aux(pp, grid_res=12, probe_hw=6, memo_mb=8.0)
    ar = P.AdaptiveRenderer(pp, aux)
    o, d = _view(30.0, hw=8)
    hint = ar.dead_hint(o, d)
    assert hint.sum() >= 32
    before = ops.dispatch_count()
    rgb, info = ar.render_tile(o[hint], d[hint])
    assert ops.dispatch_count() == before
    assert info["full_dead"] and info["dead"] == hint.sum()
    np.testing.assert_array_equal(rgb.numpy(),
                                  np.ones((int(hint.sum()), 3), np.float32))
    rep = ar.report()
    assert rep["full_dead_tiles"] == 1 and rep["dead_ray_fraction"] == 1.0
    assert rep["memo"]["hits"] == int(hint.sum()) * tiny().n_coarse
    assert rep["skipped_fine_samples"] == int(hint.sum()) * ar.budgets[-1]


# ------------------------------------------------------------------ guards --
def test_adaptive_renderer_requires_fused_kernel(nets):
    _, tpp = nets[False]
    plain = P.PackedPlcore(tiny(), tpp.params, device="cpu")
    with pytest.raises(ValueError, match="fuse_two_pass"):
        P.AdaptiveRenderer(plain, None)


def test_engine_guards_reject_incompatible_modes(nets):
    _, tpp = nets[False]
    cache = SceneCache(lambda sid: tpp, capacity_mb=64.0)
    with pytest.raises(ValueError, match="degrade_on_overload"):
        RenderEngine(cache, adaptive_sampling=True, degrade_on_overload=True)
