"""Layer-sharded PLCore weight residency (``runtime.sharding``) against the
reference's ``runtime/sharding.py``, and sharded renders on CPU cells.

The owner table, shard count, locality scores and home cell must equal the
reference's exactly for L in {8, 4, 3} trunk layers over 1, 2, 4 and 8
cells and a few salts; the reference's values come from one subprocess on
8 fake CPU devices (the conftest's ``fake_devices``) that prints them as
JSON. The port's cells are a list of devices, here ``cpu`` named several
times. Sharding is placement only: every sharded render (plain, K1 chain,
K2; f32 and RMCM) equals the replicated port render bit for bit, the
gather counters count one gather per layer per stacked array the first
time a render program shape runs (the reference's 2*2*L and 2*4*L on the
plain path), the staging counters the remote layers of a cell, and
``plcore_resident_weight_bytes`` the per-cell bytes of the layout.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.kernels import ops as jops

from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core import rmcm
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.core.plcore import plcore_decls
from repro_torch.data import rays as R
from repro_torch.kernels import fused_plcore as fp
from repro_torch.kernels import ops
from repro_torch.models.params import init_params
from repro_torch.runtime import sharding as rsh
from repro_torch.serving.scene_cache import SceneCache, plcore_nbytes

LAYERS = (8, 4, 3)
CELLS = (1, 2, 4, 8)
SALTS = ("", "scene0", "scene1", "scene2", "s0", "s1", "s2", "lego")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the test
    workers that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SNIPPET = r"""
import json
import jax
from repro.runtime import sharding as rsh
assert len(jax.devices()) == 8
out = {}
for L in %r:
    for n in %r:
        mesh = rsh.plcore_mesh(n)
        out[f"{L}/{n}"] = {
            "shard_count": rsh.plcore_shard_count(mesh, L),
            "owner": rsh.plcore_owner_table(mesh, L).astype(int).tolist(),
            "scores": rsh.plcore_locality_scores(mesh, L).tolist(),
            "unrouted": rsh.plcore_owned_layer_mask(mesh, L).tolist(),
            "home": {s: rsh.plcore_home_cell(mesh, L, s) for s in %r}}
print(json.dumps(out))
print("ALL OK")
""" % (LAYERS, CELLS, SALTS)


@pytest.fixture(scope="module")
def reference_maps(fake_devices):
    out = fake_devices(_SNIPPET)
    return json.loads(out.stdout.strip().splitlines()[-2])


def _cells(n):
    return rsh.plcore_mesh(devices=["cpu"] * n)


# ------------------------------------------------------------ owner map ----
@pytest.mark.parametrize("n", CELLS)
@pytest.mark.parametrize("L", LAYERS)
def test_owner_map_matches_reference(reference_maps, L, n):
    ref = reference_maps[f"{L}/{n}"]
    mesh = _cells(n)
    assert rsh.plcore_shard_count(mesh, L) == ref["shard_count"]
    assert rsh.plcore_owner_table(mesh, L).astype(int).tolist() == \
        ref["owner"]
    assert rsh.plcore_locality_scores(mesh, L).tolist() == ref["scores"]
    assert rsh.plcore_owned_layer_mask(mesh, L).tolist() == ref["unrouted"]
    assert {s: rsh.plcore_home_cell(mesh, L, s) for s in SALTS} == \
        ref["home"]
    # every cell owns its mask row; a split stack has one owner per layer
    for c in range(n):
        assert np.array_equal(rsh.plcore_owned_layer_mask(mesh, L, c),
                              rsh.plcore_owner_table(mesh, L)[c])
    if ref["shard_count"] > 1:
        assert (rsh.plcore_owner_table(mesh, L).sum(0) == 1).all()


def test_plcore_mesh_cells():
    """An explicit group may name one device several times and is capped
    at ``n_devices``; without a card and without a group there is no cell
    list to build."""
    mesh = rsh.plcore_mesh(devices=["cpu"] * 8)
    assert mesh == (torch.device("cpu"),) * 8
    assert len(rsh.plcore_mesh(3, devices=["cpu"] * 8)) == 3
    assert len(rsh.plcore_mesh(99, devices=["cpu"] * 2)) == 2
    assert rsh.plcore_cell_mesh(mesh, 5) == (torch.device("cpu"),)
    assert rsh.cell_stream(mesh, 0) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rsh.plcore_mesh()
    with pytest.raises(ValueError):
        rsh.plcore_mesh(devices=[])


# --------------------------------------------------------- sharded render --
def _cfg(name: str):
    """tiny() with 8 trunk layers (skip at 4), named per test: the gather
    counters count once per render program shape in the process, and the
    config is part of the shape."""
    return dataclasses.replace(tiny(), trunk_layers=8, skip_at=(4,),
                               name=f"sharding-{name}")


@pytest.fixture(scope="module")
def view_rays():
    ro, rd = R.camera_rays(R.pose_spherical(45.0, -25.0, 4.0), 12, 12, 10.8)
    return ro, rd


def _params(cfg, seed=0):
    return init_params(plcore_decls(cfg), torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_plain_render_bit_identical_and_counted(view_rays,
                                                        quantized):
    """The plain path on 8 cells: pixels equal the replicated render bit
    for bit; the first render gathers every layer of every stacked array
    of both networks (2 * 2 * L f32: trunk_w, trunk_b; 2 * 4 * L RMCM:
    mag, sgn, scl, b, the reference's counts), a repeat gathers without
    counting; the raw trunk params are dropped."""
    cfg = _cfg(f"plain-{quantized}")
    L = cfg.trunk_layers
    params = _params(cfg)
    quant = ({n: rmcm.quantize_tree(params[n]) for n in ("coarse", "fine")}
             if quantized else None)
    ro, rd = view_rays
    base = PackedPlcore(cfg, params, quant=quant, device="cpu")
    shard = PackedPlcore(cfg, params, quant=quant, shard_mesh=_cells(8))
    assert shard.device == torch.device("cpu")
    assert all("trunk" not in shard.params[n] for n in ("coarse", "fine"))
    g0, b0 = rsh.plcore_gather_count(), rsh.plcore_gather_bytes()
    img = shard.render_image(ro, rd, rays_per_batch=64)
    arrays = 4 if quantized else 2
    assert rsh.plcore_gather_count() - g0 == 2 * arrays * L
    stack_bytes = sum(a.nbytes() for p in shard.packed.values()
                      for a in p.values())
    assert rsh.plcore_gather_bytes() - b0 == stack_bytes
    assert torch.equal(img, base.render_image(ro, rd, rays_per_batch=64))
    again = shard.render_image(ro, rd, rays_per_batch=64)
    assert rsh.plcore_gather_count() - g0 == 2 * arrays * L
    assert torch.equal(img, again)
    expect = {"trunk_mag", "trunk_sgn", "trunk_scl", "trunk_b"} \
        if quantized else {"trunk_w", "trunk_b"}
    assert set(shard.packed["coarse"]) == expect


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_kernel_render_bit_identical(view_rays, fuse, quantized):
    """The kernel paths (K1 chain, K2) on 8 cells equal the replicated
    render; their layout also shards the tensor-core stream's trunk
    segments, one more stacked array per network."""
    cfg = _cfg(f"kernel-{fuse}-{quantized}")
    L = cfg.trunk_layers
    params = _params(cfg, 1)
    quant = ({n: rmcm.quantize_tree(params[n]) for n in ("coarse", "fine")}
             if quantized else None)
    ro, rd = view_rays
    kw = dict(quant=quant, use_kernel=True, fuse_two_pass=fuse)
    base = PackedPlcore(cfg, params, device="cpu", **kw)
    shard = PackedPlcore(cfg, params, shard_mesh=_cells(8), **kw)
    g0 = rsh.plcore_gather_count()
    img = shard.render_image(ro, rd, rays_per_batch=64)
    assert rsh.plcore_gather_count() - g0 == 2 * (5 if quantized else 3) * L
    assert torch.equal(img, base.render_image(ro, rd, rays_per_batch=64))
    # the gathered layout is the replicated one, key for key, bit for bit
    got = rsh.gather_plcore_packed(shard.packed["fine"], "cpu", count=False)
    for k, v in base.packed["fine"].items():
        assert torch.equal(got[k], v), k


def test_replicated_fallback_renders_and_owns_everything(view_rays):
    """3 cells do not divide 8 layers: every cell owns every layer, the
    routed gather cost is 0 and the unrouted one prices every layer."""
    cfg = _cfg("fallback")
    L = cfg.trunk_layers
    params = _params(cfg, 2)
    mesh = _cells(3)
    assert rsh.plcore_shard_count(mesh, L) == 1
    ro, rd = view_rays
    pp = PackedPlcore(cfg, params, shard_mesh=mesh)
    assert torch.equal(pp.render_image(ro, rd, rays_per_batch=64),
                       PackedPlcore(cfg, params, device="cpu").render_image(
                           ro, rd, rays_per_batch=64))
    unrouted = pp.tile_gather_cost()
    assert unrouted["layers"] == 2 * 2 * L and unrouted["bytes"] > 0
    assert pp.tile_gather_cost(rsh.plcore_home_cell(mesh, L, "x")) == \
        {"layers": 0, "bytes": 0}
    assert PackedPlcore(cfg, params, device="cpu").tile_gather_cost() == \
        {"layers": 0, "bytes": 0}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_gather_cost_prices_the_remote_layers(n):
    """A routed tile's cost drops by exactly the layers its home cell
    owns, per stacked array, at their bytes."""
    cfg = _cfg("cost")
    L = cfg.trunk_layers
    pp = PackedPlcore(cfg, _params(cfg), use_kernel=True, shard_mesh=_cells(n))
    full = pp.tile_gather_cost()
    arrays = 3                               # trunk_w, trunk_b, mma
    assert full["layers"] == 2 * arrays * L
    for c in range(n):
        cost = pp.tile_gather_cost(c)
        assert cost["layers"] == 2 * arrays * (L - L // n)
        assert cost["bytes"] < full["bytes"]
        assert pp.cell_stage_cost(c) == cost


def test_stage_to_cell_counts_remote_layers_and_keeps_values():
    cfg = _cfg("stage")
    L = cfg.trunk_layers
    params = _params(cfg, 3)
    packed = ops.kernel_weights(cfg, params["coarse"])
    mesh = _cells(4)
    sharded = rsh.shard_plcore_packed(packed, mesh, cfg)
    s0, b0 = rsh.plcore_stage_count(), rsh.plcore_stage_bytes()
    staged = rsh.stage_plcore_packed_to_cell(sharded, mesh, 2)
    assert rsh.plcore_stage_count() - s0 == 3 * (L - L // 4)
    remote = ~rsh.plcore_owned_layer_mask(mesh, L, 2)
    want = sum(nb for a in sharded.values()
               if isinstance(a, rsh.LayerShards)
               for nb, r in zip(a.layer_nbytes, remote) if r)
    assert rsh.plcore_stage_bytes() - b0 == want
    for k, v in packed.items():
        assert torch.equal(staged[k], v), k


def test_mma_stream_splits_by_trunk_layer():
    """The tensor-core stream's trunk segments come layer by layer before
    the heads: splitting and re-joining it is exact, and each layer's
    piece is that layer's segments (``fused_plcore.mma_segments``)."""
    cfg = _cfg("mma")
    for quantized in (False, True):
        p = _params(cfg, 4)["fine"]
        q = rmcm.quantize_tree(p) if quantized else None
        stream = ops.kernel_weights(cfg, p, q)["mma"]
        layers, tail = rsh._mma_layers(cfg, stream)
        assert torch.equal(torch.cat(layers + [tail]), stream)
        per = 1 if quantized else 2
        KH, KPE = fp.mma_rows(cfg)
        W = cfg.trunk_width
        rows = [KPE] + [KH + (KPE if i in cfg.skip_at else 0)
                        for i in range(1, cfg.trunk_layers)]
        assert [t.numel() for t in layers] == [per * r * W for r in rows]


# ------------------------------------------------------- resident bytes ----
@pytest.mark.parametrize("L", [4, 8])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 3])
def test_resident_weight_bytes(L, n):
    """``plcore_resident_weight_bytes`` is the per-cell bytes of a sharded
    f32 ``kernel_weights`` layout; less the tensor-core stream it is the
    reference's figure (its layout has no stream)."""
    cfg = dataclasses.replace(tiny(), trunk_layers=L,
                              skip_at=(L // 2,))
    packed = ops.kernel_weights(cfg, _params(cfg)["coarse"])
    sharded = rsh.shard_plcore_packed(packed, _cells(n), cfg)
    from repro_torch.serving.scene_cache import tree_nbytes
    assert ops.plcore_resident_weight_bytes(cfg, n) == tree_nbytes(sharded)
    k = rsh.plcore_shard_count(_cells(n), L)
    mma = sharded["mma"]
    mma_cell = max(mma.cell_nbytes(c) for c in range(n))
    jcfg = dataclasses.replace(jax_tiny(), trunk_layers=L,
                               skip_at=(L // 2,))
    assert ops.plcore_resident_weight_bytes(cfg, n) - mma_cell == \
        jops.plcore_resident_weight_bytes(jcfg, k)


def test_scene_cache_holds_more_sharded_scenes():
    """At a capacity that holds two replicated kernel residents, the
    8-cell sharded ones all fit (per-cell bytes), as in the reference."""
    cfg = _cfg("cache")
    sets = {f"s{i}": _params(cfg, i) for i in range(6)}
    per = plcore_nbytes(PackedPlcore(cfg, sets["s0"], use_kernel=True,
                                     device="cpu"))
    cap_mb = 2.5 * per / (1 << 20)

    def loader(mesh):
        return lambda sid: PackedPlcore(
            cfg, sets[sid], use_kernel=True,
            **({"shard_mesh": mesh} if mesh else {"device": "cpu"}))
    c_repl = SceneCache(loader(None), capacity_mb=cap_mb)
    c_shard = SceneCache(loader(_cells(8)), capacity_mb=cap_mb)
    for i in range(6):
        c_repl.get(f"s{i}")
        c_shard.get(f"s{i}")
    assert len(c_repl) == 2
    assert len(c_shard) == 6 and c_shard.evictions == 0
