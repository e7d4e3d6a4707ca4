"""Mip-NeRF on the port, on the CPU at small sizes, on seeded random
weights: the frustum Gaussian against quadrature of a cone segment, the
IPE at zero variance against the plain sines and cosines, the blur and
resample on hand-made weights, the port's plain path against the
benchmark's reference (``bench/reference/mipnerf.py``) in float64 and
float32, K2's plain tile body (``kernels/ref.py``) against the plain path,
the engine's cones against the reference's, the resident's refusals and
the serve CLI. K2's Mip-NeRF instance itself runs on the card only
(``tests/test_torch_mipnerf_gpu.py``). Imports no JAX."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import mipnerf as mcfg
from repro_torch.core import mipnerf, sampling
from repro_torch.core.encoding import (frustum_rows, integrated_pos_enc,
                                       lift_gaussian, nerf_encoding)
from repro_torch.data import rays as R
from repro_torch.kernels import ops, ref
from repro_torch.models.params import init_params

ROOT = Path(__file__).resolve().parents[1]
BENCH_CFG = json.loads((ROOT / "bench" / "configs"
                        / "mipnerf-icarus-f32.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference():
    import sys
    if str(ROOT) not in sys.path:
        sys.path.append(str(ROOT))
    from bench.reference import mipnerf as bref
    return bref


def _tiny_dict() -> dict:
    t = mcfg.tiny()
    return dict(BENCH_CFG, trunk_layers=t.trunk_layers,
                trunk_width=t.trunk_width, skip_at=list(t.skip_at),
                color_width=t.color_width, max_deg_point=t.max_deg_point,
                deg_view=t.deg_view, n_samples=t.n_samples)


def _port_params(net: dict, dtype) -> dict:
    def lin(k):
        w, b = net[k]
        return {"w": w.to(dtype), "b": b.to(dtype)}
    layers = len([k for k in net if k.startswith("trunk.")])
    return {"trunk": {f"l{i}": lin(f"trunk.{i}") for i in range(layers)},
            **{k: lin(k) for k in ("sigma", "feat", "color0", "rgb")}}


# ------------------------------------------------------------- the PEU ----
def test_frustum_gaussian_matches_quadrature():
    """The stable moments against a cone segment's, integrated in float64:
    the along-ray density of a cone's volume grows as t^2, so t_mean =
    E[t], t_var = Var[t], and each axis across the ray has variance
    (r t)^2 / 4 of a disk of radius r t, averaged: r_unit = E[t^2] / 4.
    Tolerance 1e-9 relative: the quadrature's (midpoint rule, 2e5 points)
    error; the closed forms are exact."""
    t0 = torch.tensor([2.0, 2.5, 3.9, 5.96875], dtype=torch.float64)
    t1 = torch.tensor([2.03125, 3.5, 4.0, 6.0], dtype=torch.float64)
    t_mean, t_var, r_unit = frustum_rows(t0, t1)
    n = 200000
    for i in range(len(t0)):
        s = (torch.arange(n, dtype=torch.float64) + 0.5) / n
        t = t0[i] + (t1[i] - t0[i]) * s
        w = t * t / (t * t).sum()
        mean = (w * t).sum()
        var = (w * (t - mean) ** 2).sum()
        radial = (w * t * t).sum() / 4
        for got, want in ((t_mean[i], mean), (t_var[i], var),
                          (r_unit[i], radial)):
            assert abs(float(got - want)) <= 1e-9 * abs(float(want)), i


def test_lift_gaussian_along_an_axis():
    """A direction along z: the variance along it is t_var |d|^2, across it
    r^2 r_unit (lift_gaussian's diagonal)."""
    o = torch.tensor([[0.1, -0.2, 4.0]], dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, -2.0]], dtype=torch.float64)
    r = torch.tensor([0.01], dtype=torch.float64)
    tm, tv, ru = (x[None] for x in frustum_rows(
        torch.tensor([2.0, 4.0], dtype=torch.float64),
        torch.tensor([2.5, 4.5], dtype=torch.float64)))
    mean, cov = lift_gaussian(o, d, r, tm, tv, ru)
    assert torch.allclose(mean[0, :, 2], 4.0 - 2.0 * tm[0], rtol=0,
                          atol=1e-15)
    assert torch.allclose(cov[0, :, 2], 4.0 * tv[0], rtol=1e-15)
    for a in (0, 1):
        assert torch.allclose(cov[0, :, a], 1e-4 * ru[0], rtol=1e-15)


def test_ipe_at_zero_variance_is_the_plain_encoding():
    """With no variance every weight is 1: the IPE is NeRF's sines and
    cosines of 2^l x, sines of every degree first. Exact: the same
    operations on the same values."""
    x = torch.randn(5, 7, 3, dtype=torch.float64)
    got = integrated_pos_enc(x, torch.zeros_like(x), 0, 6)
    plain = nerf_encoding(x, 6, include_input=False).reshape(5, 7, 6, 2, 3)
    want = torch.cat([plain[..., 0, :].reshape(5, 7, 18),
                      plain[..., 1, :].reshape(5, 7, 18)], dim=-1)
    assert torch.equal(got, want)


# ------------------------------------------------------------ resample ----
def _resample_by_hand(t, w, padding, n):
    """mip-NeRF's resample in plain Python floats: blur, pdf, CDF, and for
    each grid point the interval find_interval picks."""
    m = len(w)
    wp = [w[0]] + list(w) + [w[-1]]
    mx = [max(wp[i], wp[i + 1]) for i in range(m + 1)]
    b = [0.5 * (mx[i] + mx[i + 1]) + padding for i in range(m)]
    s = sum(b)
    cdf = [0.0]
    for i in range(m - 1):
        cdf.append(min(1.0, cdf[-1] + b[i] / s))
    cdf.append(1.0)
    out = []
    for k in range(n):
        u = k * (1 - 2.0 ** -23) / (n - 1)
        i0 = max(i for i in range(m + 1) if cdf[i] <= u)
        i1 = min([i for i in range(m + 1) if cdf[i] > u], default=m)
        frac = (u - cdf[i0]) / (cdf[i1] - cdf[i0]) if cdf[i1] > cdf[i0] \
            else 0.0
        out.append(t[i0] + min(max(frac, 0.0), 1.0) * (t[i1] - t[i0]))
    return out


@pytest.mark.parametrize("weights", [[0.0, 1.0, 0.0, 0.0],
                                     [0.0, 0.0, 0.0, 0.0],
                                     [0.2, 0.3, 0.4, 0.05],
                                     [0.0, 0.0, 0.0, 0.9]])
def test_blur_and_resample_on_hand_made_weights(weights):
    """The port's resample against the published algorithm written out by
    hand, in float64, on 4 intervals: one peak, an empty ray (the padding
    alone: uniform), a spread, the last interval. Tolerance 1e-12: float
    sums in another grouping; the reference's masks agree too."""
    t = torch.tensor([[2.0, 3.0, 4.0, 5.0, 6.0]], dtype=torch.float64)
    w = torch.tensor([weights], dtype=torch.float64)
    u = torch.linspace(0.0, 1 - 2.0 ** -23, 5, dtype=torch.float64)
    got = sampling.mip_resample(t, w, 0.01, u_row=u)
    want = torch.tensor([_resample_by_hand(t[0].tolist(), weights, 0.01, 5)],
                        dtype=torch.float64)
    assert torch.allclose(got, want, rtol=0, atol=1e-12), (got, want)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    cfg = dict(_tiny_dict(), resample_padding=0.01)
    bref = _reference()
    assert torch.allclose(bref._resample(cfg, t, w), want, rtol=0,
                          atol=1e-12)


def test_one_peak_gathers_the_fine_edges():
    """A single opaque interval draws most of the 129 edges into it and
    its blurred neighbours, and none outside [near, far]."""
    cfg = mcfg.CONFIG
    t = sampling.mip_edges(cfg.near, cfg.far, cfg.n_edges)[None]
    w = torch.zeros(1, cfg.n_samples)
    w[0, 60] = 1.0
    got = sampling.mip_resample(t, w, cfg.resample_padding)
    assert got.shape == (1, cfg.n_edges)
    inside = ((got >= t[0, 59]) & (got <= t[0, 62])).sum()
    assert int(inside) > cfg.n_edges // 2
    assert float(got.min()) >= cfg.near and float(got.max()) <= cfg.far


# --------------------------------------------------------- against refs ---
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_path_matches_the_reference(dtype):
    """The port's plain path on the reference's draw and cones. float64:
    within 1e-6, the port's grids (coarse edges, resample points) being
    float32 values. float32: within 1e-5 of the float64 reference at every
    pixel, and its mean gap within 3x the float32 reference's own (both
    round the same operations, in other orders)."""
    bref = _reference()
    cfg_d = _tiny_dict()
    net = bref.draw(cfg_d, 2718281828, 1, "cpu")
    o, d, r = bref.pixel_rays(33.0, -20.0, 4.0, 16, np.arange(0, 256, 3))
    want = bref.render(cfg_d, net, o, d, r, precision="f64")
    dt = getattr(torch, dtype)
    cfg = mcfg.MipNerfConfig(**{**mcfg.tiny().__dict__,
                                "compute_dtype": dtype})
    got = mipnerf.render_rays(cfg, _port_params(net, dt),
                              torch.tensor(o, dtype=dt),
                              torch.tensor(d, dtype=dt),
                              torch.tensor(r, dtype=dt))["rgb"].double()
    gap = (got - want).abs()
    if dtype == "float64":
        assert float(gap.max()) <= 1e-6
    else:
        floor = bref.render(cfg_d, net, o, d, r, precision="f32")
        assert float(gap.max()) <= 1e-5
        assert float(gap.mean()) <= 3 * float((floor.double()
                                               - want).abs().mean())


def test_tile_body_matches_the_plain_path():
    """K2's plain tile body (the kernel's order of operations) against the
    plain path, float32, on one tile of 100 cones: every output within
    1e-5 (their MLP sums and the VRU's weights are grouped differently;
    the resample can move an edge by that much)."""
    cfg = mcfg.tiny()
    params = init_params(mipnerf.mip_decls(cfg),
                         torch.Generator().manual_seed(5))
    o, d, r = (torch.from_numpy(x) for x in R.mip_view_rays(70.0, -30.0,
                                                            4.0, 10))
    packed = ops.kernel_weights(cfg, params)
    t_row, u_row = ops.mip_sample_rows(cfg, "cpu")
    rays = torch.cat([o, d, r], dim=1)
    body = ref.mip_two_pass_ref(cfg, packed, rays, t_row, u_row, rt=32,
                                white_bkgd=True)
    plain = mipnerf.render_rays(cfg, params, o, d, r)
    for i, key in enumerate(("rgb", "rgb_coarse", "acc", "acc_coarse",
                             "depth")):
        assert float((body[i] - plain[key]).abs().max()) <= 1e-5, key


def test_tf32x3_model_of_the_tensor_cores():
    """``ref.tf32x3_matmul``, the model of K2's full-width products that
    ``scripts/mip_err_emulation.py`` uses: TF32 rounds ties away from zero
    (1 + 2^-11 is a tie). Rounded to nearest, the split product's mean
    error against float64 is no larger than a plain f32 product's (1.4 to
    1.5 times smaller over 3 seeds); truncated, it is 16 times the nearest
    one's and points toward zero in 83% of the outputs (a share of 1/2
    would be unbiased)."""
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -12], dtype=torch.float32)
    assert ref.tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                      1.0]
    g = torch.Generator().manual_seed(9)
    a = torch.randn(64, 352, generator=g)
    b = torch.randn(352, 32, generator=g) / 16
    exact = a.double() @ b.double()
    near = float((ref.tf32x3_matmul(a, b, truncate=False).double()
                  - exact).abs().mean())
    assert near <= float(((a @ b).double() - exact).abs().mean())
    trunc = ref.tf32x3_matmul(a, b).double() - exact
    assert float(trunc.abs().mean()) >= 8 * near
    assert float((trunc * exact.sign() <= 0).double().mean()) >= 0.75


def test_engine_cones_match_the_reference_rays():
    """The engine's per-ray columns of a view (``mip_view_rays``: float32)
    against the reference's ``pixel_rays`` (float64) of the same pixels:
    within float32 rounding (1e-6 of the values' scale)."""
    bref = _reference()
    hw, pixels = 24, np.array([0, 5, 100, 287, 575])
    o, d, r = R.mip_view_rays(123.0, -31.0, 4.0, hw)
    ro, rd, rr = bref.pixel_rays(123.0, -31.0, 4.0, hw, pixels)
    assert np.allclose(o[pixels], ro, rtol=0, atol=4e-6)
    assert np.allclose(d[pixels], rd, rtol=0, atol=2e-6)
    assert np.allclose(r[pixels, 0], rr, rtol=1e-6, atol=0)
    assert r.shape == (hw * hw, 1)


# --------------------------------------------------------- the resident ---
def _resident(**kw):
    cfg = mcfg.tiny()
    params = init_params(mipnerf.mip_decls(cfg),
                         torch.Generator().manual_seed(0))
    return mipnerf.PackedMipNerf(cfg, params, device="cpu", **kw)


def test_resident_refuses_what_mipnerf_does_not_define():
    cfg = mcfg.tiny()
    params = init_params(mipnerf.mip_decls(cfg),
                         torch.Generator().manual_seed(0))
    for kw in ({"quant": {}}, {"ert_eps": 0.01},
               {"shard_mesh": ["cpu", "cpu"]}):
        with pytest.raises(ValueError, match="Mip-NeRF"):
            mipnerf.PackedMipNerf(cfg, params, device="cpu", **kw)
    pp = _resident(use_kernel=True)
    o, d, r = R.mip_view_rays(0.0, -20.0, 4.0, 4)
    for kw in ({"ert_eps": 0.01}, {"budget": 8},
               {"alive": np.ones(16, np.float32)},
               {"home_cell": 0, "percell": True}, {"coarse_only": True}):
        with pytest.raises(ValueError, match="Mip-NeRF"):
            pp.dispatch_tile(o, d, r, **kw)
    with pytest.raises(ValueError, match="coarse-only"):
        pp.render_tile(o, d, r, coarse_only=True)


def test_resident_dispatch_oracle_and_cache_bytes():
    """A dispatched tile (K2's plain version on the CPU) equals the oracle
    rung (the plain path) within 1e-5, and the cache counts one network
    and its layout."""
    from repro_torch.serving.scene_cache import plcore_nbytes, tree_nbytes
    pp = _resident(use_kernel=True)
    o, d, r = R.mip_view_rays(10.0, -25.0, 4.0, 6)
    handle, cost = pp.dispatch_tile(o, d, r)
    got = handle.result()
    assert cost == {"layers": 0, "bytes": 0}
    oracle = pp.render_tile_oracle(o, d, r).numpy()
    assert np.abs(got - oracle).max() <= 1e-5
    assert plcore_nbytes(pp) == tree_nbytes(pp.params) + tree_nbytes(
        pp.packed)


def test_oracle_on_the_card_launches_the_kernel(monkeypatch):
    """The retry ladder's last rung of a kernel resident on the card is
    K2's Mip-NeRF instance again, never the plain path; on the CPU, and
    without ``use_kernel``, the plain path. The card is stood in for by the
    device's type, the launch by a recorder."""
    from repro_torch.kernels import ops as kops
    calls = []

    def recorder(name):
        def call(cfg, params, rays, *rest, **kw):
            calls.append(name)
            return {"rgb": torch.zeros(rays.shape[0], 3)}
        return call

    monkeypatch.setattr(kops, "fused_render_mip", recorder("kernel"))
    monkeypatch.setattr(mipnerf, "render_rays", recorder("plain"))
    o, d, r = R.mip_view_rays(10.0, -25.0, 4.0, 4)
    pp = _resident(use_kernel=True)
    pp.render_tile_oracle(o, d, r)
    assert calls == ["plain"]
    pp.device = torch.device("cuda")
    monkeypatch.setattr(pp, "_rays", lambda o, d, r: torch.cat(
        [torch.as_tensor(x).reshape(len(o), -1) for x in (o, d, r)], 1))
    pp.render_tile_oracle(o, d, r)
    assert calls == ["plain", "kernel"]
    pp.use_kernel = False
    pp.render_tile_oracle(o, d, r)
    assert calls == ["plain", "kernel", "plain"]


def test_engine_fault_ladder_ends_on_the_oracle():
    """Faults on every fresh dispatch drive a tile down the retry ladder to
    the oracle rung, which renders the tile the fault plan never touches:
    every view is delivered with the fault-free engine's pixels."""
    from repro_torch.serving import (FaultConfig, FaultPlan, RenderEngine,
                                     RenderRequest, SceneCache)
    cfg = mcfg.tiny()

    def load(sid):
        params = init_params(mipnerf.mip_decls(cfg),
                             torch.Generator().manual_seed(int(sid[-1])))
        return mipnerf.PackedMipNerf(cfg, params, use_kernel=True,
                                     device="cpu")

    def run(faults):
        eng = RenderEngine(SceneCache(load), tile_rays=32, faults=faults,
                           max_tile_retries=1)
        rids = [eng.submit(RenderRequest(scene_id=f"scene{i % 2}", hw=7,
                                         theta=40.0 * i))
                for i in range(3)]
        eng.drain()
        return eng, [eng.take(rid) for rid in rids]

    _, clean = run(None)
    eng, faulty = run(FaultPlan(FaultConfig(seed=3, dispatch_error_rate=1.0)))
    assert eng.stats["oracle_fallbacks"] >= 1
    for a, b in zip(clean, faulty):
        assert b.status == "ok"
        np.testing.assert_allclose(b.image, a.image, rtol=0, atol=1e-5)


def test_serve_engine_mipnerf_on_cpu_and_its_refusals(capsys):
    """``serve --mode engine --model mipnerf`` builds the engine over
    Mip-NeRF residents and passes ``--check`` (every view completes, depth
    2 equals depth 1 bit for bit), alone and behind the two-host cluster
    engine; NeRF-only flags are refused."""
    from repro_torch.launch import serve
    argv = ["--mode", "engine", "--model", "mipnerf", "--device", "cpu",
            "--kernel", "--fuse-two-pass", "--hw-mix", "6,9",
            "--tile-rays", "32", "--loop", "closed", "--pipeline-depth", "2",
            "--requests", "6", "--check"]
    report = serve.main(argv)
    assert report["model"] == "mipnerf"
    assert report["check_compared"]["depth1"] == 6
    report = serve.main(argv + ["--hosts", "2"])
    assert (report["hosts"], report["requests_delivered"]) == (2, 6)
    assert report["check_compared"]["depth1"] == 6
    for extra in (["--rmcm"], ["--ert", "0.01"], ["--adaptive-sampling"],
                  ["--degrade-on-overload"], ["--shard-weights"]):
        with pytest.raises(SystemExit, match="mipnerf"):
            serve.main(argv + extra)
    with pytest.raises(SystemExit, match="mipnerf"):
        serve.main(["--mode", "nerf", "--model", "mipnerf", "--device",
                    "cpu"])


def test_published_config_counts():
    """The port's published config: 612,740 parameters a network, 96 IPE
    and 27 viewdir features, 128 intervals a level from 129 edges; K2's
    tensor-core layers 606,208 multiply-adds a sample."""
    cfg = mcfg.CONFIG
    decls = mipnerf.mip_decls(cfg)
    n = sum(math.prod(leaf.shape) for layer in
            [*decls["trunk"].values(),
             *(decls[k] for k in ("sigma", "feat", "color0", "rgb"))]
            for leaf in layer.values())
    assert n == 612740
    assert (cfg.pos_enc_dim, cfg.dir_enc_dim, cfg.n_edges) == (96, 27, 129)
    W, C, pe = cfg.trunk_width, cfg.color_width, cfg.pos_enc_dim
    mma = pe * W + 7 * W * W + pe * W + W * W + W * C
    assert mma == 606208
