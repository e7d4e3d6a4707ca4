"""The slice-1 modules the port had left out, against the reference on the
same numpy inputs: the universal PEU (``make_frequency_matrix``,
``fourier_features``, ``PEU``; the reference's keyed matrices cross as
data), the generic coordinate MLP (``mlp_decls``/``mlp_apply``, plain and
RMCM), the VRU's ``render_ref`` and ``render_scan`` (the cases of
``tests/test_volume.py`` and against ``render_parallel``), the seed's
per-tile image loop (``render_image_tiled``, the rows of
``tests/test_pipeline.py``) and ``serve --tiled``. Tolerances as the
ground rules pin them: exact for structure and RMCM packing, 1e-5 for
float paths and batch invariance, 5e-3 with RMCM or kernel against
plain."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core import encoding as je, mlp as jm, rmcm as jr
from repro.core import sampling as js, volume as jv
from repro.core.plcore import plcore_decls as jax_plcore_decls
from repro.core.plcore import render_image_tiled as jax_render_image_tiled
from repro.data import rays as jrays
from repro.models.params import init_params as jax_init_params

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core import encoding, mlp, plcore, rmcm, volume
from repro_torch.core import sampling
from repro_torch.data import rays
from repro_torch.launch import serve

RNG = np.random.default_rng(4321)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                               **(kw or dict(rtol=1e-5, atol=1e-5)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _to_t(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree))


# ------------------------------------------------------------------ PEU ---
@pytest.mark.parametrize("L", [1, 5, 10])
def test_fixed_frequency_matrix_equals_reference(L):
    a = je.make_frequency_matrix("nerf_fixed", 3, 3 * L)
    b = encoding.make_frequency_matrix("nerf_fixed", 3, 3 * L)
    assert b.dtype == torch.float32
    assert np.array_equal(np.asarray(a), b.numpy())


def test_fixed_frequency_matrix_equals_encoding():
    """[cos(A^T x) | sin(A^T x)] of the fixed matrix is the NeRF encoding
    regrouped (the reference test's case, on the port)."""
    x = _t(RNG.normal(size=(4, 3)).astype(np.float32))
    L = 5
    ff = encoding.fourier_features(
        x, encoding.make_frequency_matrix("nerf_fixed", 3, 3 * L))
    e = encoding.nerf_encoding(x, L, include_input=False)
    sins = torch.cat([e[:, 6 * k:6 * k + 3] for k in range(L)], -1)
    coss = torch.cat([e[:, 6 * k + 3:6 * k + 6] for k in range(L)], -1)
    torch.testing.assert_close(ff[:, 3 * L:], sins, atol=1e-5, rtol=0)
    torch.testing.assert_close(ff[:, :3 * L], coss, atol=1e-5, rtol=0)


def test_fourier_features_match_reference():
    x = RNG.normal(size=(7, 5, 3)).astype(np.float32)
    A = (10.0 * RNG.normal(size=(3, 32))).astype(np.float32)
    _close(je.fourier_features(jnp.asarray(x), jnp.asarray(A)),
           encoding.fourier_features(_t(x), _t(A)), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mode", ["rff_iso", "rff_aniso"])
@pytest.mark.parametrize("include_input", [True, False])
def test_rff_peu_on_the_references_matrix(mode, include_input):
    """The reference's keyed matrix crosses as data: the port's PEU on it
    equals the reference's PEU."""
    kw = dict(sigmas=np.array([8.0, 8.0, 1.0])) if mode == "rff_aniso" \
        else {}
    ref = je.PEU(mode, 3, n_features=64, key=jax.random.PRNGKey(1),
                 sigma=5.0, include_input=include_input, **kw)
    ours = encoding.PEU(mode, 3, n_features=64, A=np.asarray(ref.A),
                        include_input=include_input)
    assert ours.out_dim == ref.out_dim
    assert np.array_equal(ours.A.numpy(), np.asarray(ref.A))
    x = RNG.normal(size=(10, 3)).astype(np.float32)
    _close(ref(jnp.asarray(x)), ours(_t(x)), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mode", ["rff_iso", "rff_aniso"])
def test_rff_peu_drawn_from_a_generator(mode):
    """The keyed route's properties (the reference's test_rff_modes and
    aniso bandwidth cases): cos^2 + sin^2 = 1, the shape, the per-axis
    bandwidth, and one generator state giving one matrix."""
    sig = np.array([20.0, 1.0, 1.0]) if mode == "rff_aniso" else None

    def make(seed):
        return encoding.PEU(mode, 3, n_features=256, sigma=5.0, sigmas=sig,
                            generator=torch.Generator().manual_seed(seed))
    peu = make(1)
    assert torch.equal(peu.A, make(1).A) and not torch.equal(peu.A,
                                                              make(2).A)
    e = peu(_t(RNG.normal(size=(10, 3)).astype(np.float32)))
    assert e.shape == (10, peu.out_dim) == (10, 3 + 512)
    c, s = e[:, 3:259], e[:, 259:]
    torch.testing.assert_close(c * c + s * s, torch.ones_like(c), atol=1e-5,
                               rtol=0)
    A = peu.A.abs().mean(dim=1)
    if mode == "rff_aniso":
        assert A[0] > 5 * A[1]
    else:
        assert float(A.mean()) == pytest.approx(5.0 * np.sqrt(2 / np.pi),
                                                rel=0.1)
    with pytest.raises(ValueError, match="generator"):
        encoding.PEU(mode, 3, n_features=8, sigmas=sig)


@pytest.mark.parametrize("double_angle", [False, True])
def test_nerf_peu_matches_reference(double_angle):
    ref = je.PEU("nerf_fixed", 3, n_freqs=8, double_angle=double_angle)
    ours = encoding.PEU("nerf_fixed", 3, n_freqs=8,
                        double_angle=double_angle)
    assert ours.out_dim == ref.out_dim == 51
    assert np.array_equal(ours.A.numpy(), np.asarray(ref.A))
    x = RNG.normal(size=(6, 3)).astype(np.float32)
    # the recurrence's rounding compounds over the octaves (the reference
    # bounds it by 3e-4 against the direct form): the two packages round
    # its products in another order
    _close(ref(jnp.asarray(x)), ours(_t(x)),
           atol=3e-4 if double_angle else 1e-5, rtol=1e-5)
    # the flag changes the route, not the values, beyond the recurrence's
    # error (the reference's 3e-4)
    other = encoding.PEU("nerf_fixed", 3, n_freqs=8,
                         double_angle=not double_angle)
    torch.testing.assert_close(ours(_t(x)), other(_t(x)), atol=3e-4, rtol=0)


# ------------------------------------------------------------------ MLP ---
def test_mlp_decls_match_reference():
    a = jm.mlp_decls(3, [64, 64], 4)
    b = mlp.mlp_decls(3, [64, 64], 4)
    assert sorted(a) == sorted(b) == ["l0", "l1", "l2"]
    for k in a:
        for leaf in ("w", "b"):
            assert tuple(a[k][leaf].shape) == b[k][leaf].shape
            assert a[k][leaf].init == b[k][leaf].init


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("final", [None, "sigmoid"])
def test_mlp_apply_matches_reference(quantized, final):
    p = jax_init_params(jm.mlp_decls(3, [64, 32], 4), jax.random.PRNGKey(5),
                        "float32")
    q = jr.quantize_tree(p) if quantized else None
    x = RNG.normal(size=(9, 5, 3)).astype(np.float32)
    fj = {None: None, "sigmoid": jax.nn.sigmoid}[final]
    ft = {None: None, "sigmoid": torch.sigmoid}[final]
    yj = jm.mlp_apply(p, jnp.asarray(x), quant=q, final_activation=fj)
    yt = mlp.mlp_apply(_to_t(p), _t(x), quant=_to_t(q) if quantized else None,
                       final_activation=ft)
    assert yt.shape == (9, 5, 4)
    tol = 5e-3 if quantized else 1e-5
    _close(yj, yt, atol=tol, rtol=1e-5)
    if quantized:
        # the RMCM route reads the packed magnitudes: not the exact weights
        exact = mlp.mlp_apply(_to_t(p), _t(x), final_activation=ft)
        assert not torch.equal(exact, yt)


# ------------------------------------------------------------------ VRU ---
def _random_ray(n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    sigma = np.maximum(rng.normal(size=(batch, n)) * 2, 0).astype(np.float32)
    rgb = (1 / (1 + np.exp(-rng.normal(size=(batch, n, 3))))).astype(
        np.float32)
    t = (np.sort(rng.uniform(size=(batch, n)), -1) * 4 + 2).astype(
        np.float32)
    return sigma, rgb, t


@pytest.mark.parametrize("n", [1, 2, 7, 64, 192])
@pytest.mark.parametrize("cap", [1.0, 1e10])
def test_eq4_eq5_parallel_agree_and_match_reference(n, cap):
    """The three forms agree on the port (the reference test's case), and
    each matches the reference's form of the same name."""
    sigma, rgb, t = _random_ray(n, seed=n)
    d = np.asarray(js.deltas_from_t(jnp.asarray(t), far_cap=cap))
    out = {}
    for name in ("render_ref", "render_scan", "render_parallel"):
        rj, aj = getattr(jv, name)(jnp.asarray(sigma), jnp.asarray(rgb),
                                   jnp.asarray(d))
        rt, at = getattr(volume, name)(_t(sigma), _t(rgb), _t(d))
        _close(rj, rt)
        for k in ("weights", "transmittance", "acc"):
            _close(aj[k], at[k])
        out[name] = (rt, at)
    for name in ("render_scan", "render_parallel"):
        torch.testing.assert_close(out[name][0], out["render_ref"][0],
                                   atol=1e-5, rtol=0)
        torch.testing.assert_close(out[name][1]["weights"],
                                   out["render_ref"][1]["weights"],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("form", ["render_ref", "render_scan"])
def test_vru_invariants(form):
    """The reference's analytic cases on render_ref and render_scan:
    partition of unity under an opaque far cap, zero density, an opaque
    first sample, the depth of a thin shell."""
    render = getattr(volume, form)
    sigma, rgb, t = _random_ray(64)
    d = sampling.deltas_from_t(_t(t), far_cap=1e10)
    _, aux = render(_t(sigma) + 0.5, _t(rgb), d)
    torch.testing.assert_close(aux["acc"], torch.ones(4), atol=1e-5, rtol=0)

    t16 = torch.linspace(2, 6, 16).expand(2, 16)
    out, aux = render(torch.zeros(2, 16), torch.full((2, 16, 3), 0.7),
                      sampling.deltas_from_t(t16))
    assert float(out.abs().max()) <= 1e-7 and float(aux["acc"].max()) <= 1e-7

    s1 = torch.zeros(1, 16)
    s1[0, 0] = 1e6
    c1 = torch.zeros(1, 16, 3)
    c1[0, 0] = torch.tensor([1.0, 0.0, 0.5])
    out, _ = render(s1, c1, sampling.deltas_from_t(t16[:1]))
    torch.testing.assert_close(out[0], torch.tensor([1.0, 0.0, 0.5]),
                               atol=1e-5, rtol=0)

    t32 = torch.linspace(2, 6, 32)[None]
    s2 = torch.zeros(1, 32)
    s2[0, 10] = 1e6
    _, aux = render(s2, torch.ones(1, 32, 3), sampling.deltas_from_t(t32))
    depth = volume.composite_depth(aux["weights"], t32)
    assert float(depth[0]) == pytest.approx(float(t32[0, 10]), rel=1e-4)


def test_render_scan_transmittance_is_monotone():
    rng = np.random.default_rng(9)
    sig = torch.from_numpy(rng.uniform(0, 50, (3, 24)).astype(np.float32))
    dl = torch.from_numpy(rng.uniform(1e-3, 1.0, (3, 24)).astype(np.float32))
    _, aux = volume.render_scan(sig, torch.full((3, 24, 3), 0.5), dl)
    assert bool((torch.diff(aux["transmittance"], dim=-1) <= 1e-6).all())
    assert bool((aux["weights"] >= -1e-6).all())
    assert bool(((aux["acc"] >= -1e-5) & (aux["acc"] <= 1 + 1e-5)).all())


# ---------------------------------------------------------- tiled image ---
@pytest.fixture(scope="module")
def image_setup():
    cfg_j = jax_tiny()
    p = jax_init_params(jax_plcore_decls(cfg_j), jax.random.PRNGKey(0),
                        "float32")
    scene = jrays.blob_scene()
    ro, rd = jrays.camera_rays(jrays.pose_spherical(30.0, -20.0,
                                                    scene.radius),
                               16, 16, 14.4)
    return cfg_j, p, np.asarray(ro), np.asarray(rd)


@pytest.mark.parametrize("quantized", [False, True])
def test_render_image_tiled_matches_reference(image_setup, quantized):
    """The seed loop on both packages from the reference's weights: within
    1e-3 (5e-3 with RMCM), as the two packages' single-call images are
    (``test_torch_pipeline``: the resampler turns last-ulp differences of
    the coarse pass into moved fine samples); and the port's single-call
    image within 1e-5 of its own tiled loop, at two batch sizes (the
    reference's rows hold them bit for bit; the port's batch sizes
    reorder matmul sums)."""
    cfg_j, p, ro, rd = image_setup
    q = ({n: jr.quantize_tree(p[n]) for n in ("coarse", "fine")}
         if quantized else None)
    a = jax_render_image_tiled(cfg_j, p, jnp.asarray(ro), jnp.asarray(rd),
                               quant=q, rays_per_batch=64)
    cfg = tiny()
    qt = _to_t(q) if quantized else None
    b = plcore.render_image_tiled(cfg, _to_t(p), _t(ro), _t(rd), quant=qt,
                                  rays_per_batch=64)
    assert b.shape == (16, 16, 3)
    _close(a, b, atol=5e-3 if quantized else 1e-3, rtol=0)
    c = plcore.render_image(cfg, _to_t(p), _t(ro), _t(rd), quant=qt,
                            rays_per_batch=64)
    torch.testing.assert_close(c, b, atol=1e-5, rtol=0)
    d = plcore.render_image(cfg, _to_t(p), _t(ro), _t(rd), quant=qt,
                            rays_per_batch=128)
    torch.testing.assert_close(d, c, atol=1e-5, rtol=0)


def test_render_image_tiled_kernel_route(image_setup):
    """``use_kernel`` runs the two-dispatch chain per tile (the K1 plain
    version here; K1 on the card), within 5e-3 of the plain loop."""
    cfg_j, p, ro, rd = image_setup
    cfg = tiny()
    a = plcore.render_image_tiled(cfg, _to_t(p), _t(ro), _t(rd),
                                  rays_per_batch=64)
    b = plcore.render_image_tiled(cfg, _to_t(p), _t(ro), _t(rd),
                                  use_kernel=True, rays_per_batch=64)
    torch.testing.assert_close(b, a, atol=5e-3, rtol=0)


def test_serve_tiled_on_cpu(tmp_path):
    """``serve --tiled`` renders through the tiled loop (the image equals a
    direct ``render_image_tiled`` of the same weights and pose bit for
    bit), reports its pipeline, and refuses --ert and --fuse-two-pass."""
    argv = ["--mode", "nerf", "--device", "cpu", "--hw", "16",
            "--rays-per-batch", "64", "--out", str(tmp_path)]
    stats = serve.main(argv + ["--tiled"])
    assert stats["pipeline"] == "tiled" and stats["config"] == "tiny"
    served = np.load(stats["views"][0]["pixels"])
    args = serve.build_parser().parse_args(argv)
    model = serve.load_plcore(tiny(), args, args.seed)
    ro, rd = rays.camera_rays(rays.pose_spherical(45.0, -25.0,
                                                  rays.blob_scene().radius),
                              16, 16, 0.9 * 16)
    direct = plcore.render_image_tiled(tiny(), model.params, ro, rd,
                                       rays_per_batch=64)
    assert np.array_equal(served, direct.numpy())
    single = serve.main(argv)
    np.testing.assert_allclose(np.load(single["views"][0]["pixels"]),
                               served, atol=1e-5, rtol=0)
    for bad in (["--ert", "0.1"], ["--kernel", "--fuse-two-pass"]):
        with pytest.raises(SystemExit, match="--tiled"):
            serve.main(argv + ["--tiled"] + bad)
