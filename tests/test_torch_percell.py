"""Shard routing and per-cell dispatch in the port's serving engine, after
the reference's ``tests/test_engine_async.py`` (routing accounting, the
per-cell leg of its 8-device subprocess) and ``serve``'s flag checks.

Cells are ``cpu`` named several times (``runtime.sharding.plcore_mesh``
with an explicit device list), so every per-cell tile runs the plain
versions; on the card the same code puts each cell's launches on its own
stream (``chip_smoke.py``'s ``percell engine:`` phase). The per-cell and
routed engines must give the unrouted engine's images bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.core.plcore import plcore_decls
from repro_torch.launch import serve
from repro_torch.models.params import init_params
from repro_torch.runtime import sharding as rsh
from repro_torch.serving import RenderEngine, RenderRequest, SceneCache

TILE = 64
REQS = [RenderRequest("s0", hw=10, theta=10.0),
        RenderRequest("s1", hw=12, theta=50.0),
        RenderRequest("s0", hw=12, theta=90.0),
        RenderRequest("s2", hw=10, theta=130.0)]


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
    cfg = dataclasses.replace(tiny(), trunk_layers=8, skip_at=(4,))
    sets = {f"s{i}": init_params(plcore_decls(cfg),
                                 torch.Generator().manual_seed(i))
            for i in range(3)}
    return cfg, sets


def _engine(cfg, sets, mesh, **kw):
    pp_kw = {k: kw.pop(k) for k in ("use_kernel", "fuse_two_pass")
             if k in kw}
    cache = SceneCache(
        lambda sid: PackedPlcore(
            cfg, sets[sid], **pp_kw,
            **({"shard_mesh": mesh} if mesh else {"device": "cpu"})),
        capacity_mb=256.0)
    return RenderEngine(cache, tile_rays=TILE, **kw)


def _run(eng, reqs=REQS):
    rids = [eng.submit(r) for r in reqs]
    eng.drain()
    assert eng.in_flight_tiles == 0
    return [eng.completed[r].image for r in rids]


def test_routed_engine_reduces_gather_accounting(setup):
    """Routing over sharded residents: on one cell (replicated) a routed
    tile gathers nothing and an unrouted one every layer of both networks'
    two stacks; on 4 cells routing saves the home cell's quarter; pixels
    equal throughout."""
    cfg, sets = setup
    L = cfg.trunk_layers
    base = _run(_engine(cfg, sets, None, pipeline_depth=2))
    for n, owned in ((1, L), (4, L // 4)):
        mesh = rsh.plcore_mesh(devices=["cpu"] * n)
        runs = {}
        for routed in (True, False):
            eng = _engine(cfg, sets, mesh, pipeline_depth=2,
                          route_by_shard=routed)
            runs[routed] = (eng, _run(eng))
        (r_eng, r_img), (u_eng, u_img) = runs[True], runs[False]
        d = u_eng.stats["dispatches"]
        assert r_eng.stats["routed_tiles"] == r_eng.stats["dispatches"] == d
        assert "routed_tiles" not in u_eng.stats
        assert u_eng.stats["plcore_gather_count"] == d * 2 * 2 * L
        assert r_eng.stats["plcore_gather_count"] == d * 2 * 2 * (L - owned)
        assert r_eng.stats["plcore_gather_bytes"] < \
            u_eng.stats["plcore_gather_bytes"]
        for a, b, c in zip(base, r_img, u_img):
            assert np.array_equal(a, b) and np.array_equal(a, c)
            assert np.isfinite(a).all()


@pytest.mark.parametrize("kernel", [False, True])
def test_percell_dispatch_on_eight_cells(setup, kernel):
    """Per-cell dispatch on 8 cells (one trunk layer each): images equal
    the unrouted replicated engine's bit for bit; every dispatch ran on its
    home cell with no per-dispatch gather; each scene staged into its home
    cell once, paying its 7 remote layers per stacked array per network;
    at least two cells held tiles in flight."""
    cfg, sets = setup
    L = cfg.trunk_layers
    mesh = rsh.plcore_mesh(devices=["cpu"] * 8)
    homes = {s: rsh.plcore_home_cell(mesh, L, s) for s in ("s0", "s1", "s2")}
    assert len(set(homes.values())) >= 2, homes
    kw = dict(use_kernel=True, fuse_two_pass=True) if kernel else {}
    base = _run(_engine(cfg, sets, None, pipeline_depth=2, **dict(kw)))
    spmd = _engine(cfg, sets, mesh, pipeline_depth=2, route_by_shard=True,
                   **dict(kw))
    spmd_img = _run(spmd)
    eng = _engine(cfg, sets, mesh, pipeline_depth=2, route_by_shard=True,
                  percell_dispatch=True, **dict(kw))
    img = _run(eng)
    for a, b, c in zip(base, spmd_img, img):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    st = eng.stats
    arrays = 3 if kernel else 2        # the kernels' layout adds "mma"
    assert st["percell_tiles"] == st["dispatches"] > 0
    assert st["plcore_gather_count"] == 0
    assert spmd.stats["plcore_gather_count"] > 0
    assert st["percell_stage_events"] == 3
    assert st["percell_stage_layers"] == 3 * 2 * arrays * (L - 1)
    rep = eng.percell_report()
    assert rep["percell_tiles"] == st["percell_tiles"]
    assert rep["cells_active"] == len(set(homes.values())) >= 2
    assert set(rep["cells"]) == {str(c) for c in homes.values()}
    assert sum(v["dispatches"] for v in rep["cells"].values()) == \
        st["dispatches"]
    assert sum(1 for v in rep["cells"].values()
               if v["max_in_flight"] >= 1) >= 2
    assert max(v["max_in_flight"] for v in rep["cells"].values()) <= 2
    # the staged views live on their cells; a repeat stages nothing
    pp = eng.cache.get("s0")
    assert pp.staged_cells() == [homes["s0"]]
    _run(eng)
    assert eng.stats["percell_stage_events"] == 3


def test_percell_dispatch_tile_cost_and_pins(setup):
    """``dispatch_tile(percell=True)`` returns the cell and the staging
    cost on the first dispatch only; the scene cache books pins per cell."""
    cfg, sets = setup
    mesh = rsh.plcore_mesh(devices=["cpu"] * 4)
    pp = PackedPlcore(cfg, sets["s0"], shard_mesh=mesh)
    o = np.zeros((8, 3), np.float32)
    o[:, 2] = 4.0
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (8, 1))
    h1, c1 = pp.dispatch_tile(o, d, home_cell=1, percell=True)
    h2, c2 = pp.dispatch_tile(o, d, home_cell=1, percell=True)
    stage = pp.cell_stage_cost(1)
    assert c1 == {"layers": 0, "bytes": 0, "cell": 1,
                  "stage_layers": stage["layers"],
                  "stage_bytes": stage["bytes"]}
    assert c2["stage_layers"] == c2["stage_bytes"] == 0
    assert np.array_equal(h1.result(), h2.result())
    assert np.array_equal(h1.result(), pp.render_tile(o, d).numpy())
    with pytest.raises(ValueError, match="replicated single-cell"):
        pp.dispatch_tile(o, d, home_cell=1, percell=True, budget=4)
    cache = SceneCache(lambda sid: pp)
    cache.get("s0")
    cache.pin("s0", cell=1)
    cache.pin("s0", cell=1)
    cache.pin("s0", cell=3)
    assert cache.pinned_cells("s0") == {1: 2, 3: 1}
    cache.unpin("s0", cell=1)
    cache.unpin("s0", cell=3)
    assert cache.pinned_cells("s0") == {1: 1} and cache.pinned("s0")
    cache.unpin("s0", cell=1)
    assert cache.pinned_cells("s0") == {} and not cache.pinned("s0")


def test_engine_argument_checks(setup):
    cfg, sets = setup
    with pytest.raises(ValueError, match="route_by_shard=True"):
        _engine(cfg, sets, None, percell_dispatch=True)
    with pytest.raises(ValueError, match="replicated single-cell"):
        _engine(cfg, sets, None, route_by_shard=True,
                adaptive_sampling=True)
    # the routing and per-cell blocks are bound only when armed
    assert "percell_tiles" not in _engine(cfg, sets, None).stats
    assert _engine(cfg, sets, None).percell_report() is None


@pytest.mark.parametrize("extra, msg", [
    (["--percell-dispatch"], "requires --route-by-shard"),
    (["--route-by-shard"], "requires --shard-weights"),
    (["--shard-weights", "--route-by-shard", "--percell-dispatch",
      "--kernel", "--fuse-two-pass", "--adaptive-sampling"],
     "incompatible with --shard-weights"),
])
def test_serve_sharding_flag_checks(extra, msg):
    with pytest.raises(SystemExit, match=msg):
        serve.main(["--mode", "engine", "--device", "cpu", *extra])


def test_serve_nerf_shard_weights_on_cpu(tmp_path):
    """``--shard-weights`` on the CPU: one cell, as one device gives the
    reference one; the stats name the cells and the shard count; the
    measured energy is None off the card."""
    stats = serve.main(["--mode", "nerf", "--device", "cpu", "--hw", "8",
                        "--shard-weights", "--out", str(tmp_path)])
    assert stats["shard_devices"] == 1 and stats["weight_shards"] == 1
    assert stats["uj_per_sample_measured"] is None
    assert stats["weight_packs_since_load"] == 0
    with pytest.raises(SystemExit, match="drop --tiled"):
        serve.main(["--mode", "nerf", "--device", "cpu", "--tiled",
                    "--shard-weights"])


def test_serve_percell_check_gates_on_cpu_cells():
    """``run_engine`` with a 4-cell list and ``check_engine``'s gates:
    depth 1, unrouted and mesh-wide routed reruns all equal bit for bit,
    per-cell tiles and stagings counted, cross-cell concurrency; and the
    shard-count gate refuses a replicated fallback."""
    argv = ["--mode", "engine", "--device", "cpu", "--kernel",
            "--fuse-two-pass", "--hw-mix", "8,16", "--tile-rays", "64",
            "--loop", "closed", "--pipeline-depth", "2", "--scenes", "3",
            "--requests", "6", "--check", "--shard-weights",
            "--route-by-shard", "--percell-dispatch"]
    args = serve.build_parser().parse_args(argv)
    mesh = rsh.plcore_mesh(devices=["cpu"] * 4)
    report, engine, _, rerun = serve.run_engine(args, shard_mesh=mesh)
    assert report["shard_devices"] == 4 and report["weight_shards"] == 4
    assert report["percell"]["percell_tiles"] == \
        report["engine"]["dispatches"]
    compared = serve.check_engine(args, report, engine, rerun)
    assert set(compared) == {"depth1", "unrouted", "spmd"}
    assert all(n >= 1 for n in compared.values())
    report_1 = dict(report, weight_shards=1)
    with pytest.raises(SystemExit, match="fell back to replicated"):
        serve.check_sharding(args, report_1, engine, rerun)
