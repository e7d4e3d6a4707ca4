"""The paper's SDF and SLF workloads (``core.sdf``, ``core.slf``) and the
generic MLP's K3 route, against the reference on the same numpy inputs.

The PEU frequency matrices and the weights are the reference's, carried
across as data (``bridge.peu_from_numpy``, ``bridge.mlp_from_numpy``).
Tolerances: 1e-5 for f32 evaluation, 5e-3 with RMCM weights (the ground
rules' kernel-vs-plain and RMCM tolerance), exact for the packing. The K3
call itself is held to its plain version on the card
(``tests/test_torch_kernels_gpu.py``); here a packed layer takes the plain
product of its unpacked weight.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rmcm as jr, sdf as jsdf, slf as jslf
from repro.core.encoding import PEU as JPEU
from repro.models.params import init_params as jax_init_params

from repro_torch import bridge
from repro_torch.core import mlp, rmcm, sdf, slf
from repro_torch.models.params import init_params
from repro_torch.optim.adam import AdamConfig, adam_update, opt_state_decls

RNG = np.random.default_rng(1717)
WIDTHS = (64, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the test
    workers that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def sdf_model():
    """The reference's SDF network (rff_iso, 64 features, sigma 2 at
    widths (64, 64)) and its RMCM quant tree, and the port's copies."""
    key = jax.random.PRNGKey(7)
    jpeu = JPEU("rff_iso", 3, n_features=64, key=key, sigma=2.0)
    jp = jax_init_params(jsdf.sdf_decls(jpeu, widths=WIDTHS), key, "float32")
    jq = jr.quantize_tree(jp)
    peu = bridge.peu_from_numpy("rff_iso", 3, np.asarray(jpeu.A))
    p, q = bridge.mlp_from_numpy(_np(jp), _np(jq))
    _, qp = bridge.mlp_from_numpy(_np(jp), _np(jq), pack=True)
    return {"jpeu": jpeu, "jp": jp, "jq": jq, "peu": peu, "p": p, "q": q,
            "qp": qp}


@pytest.fixture(scope="module")
def slf_model():
    key = jax.random.PRNGKey(8)
    jpeu = jslf.make_slf_peu(key, n_features=64)
    jp = jax_init_params(jslf.slf_decls(jpeu, widths=WIDTHS), key, "float32")
    jq = jr.quantize_tree(jp)
    peu = slf.make_slf_peu(n_features=64, A=np.asarray(jpeu.A))
    p, q = bridge.mlp_from_numpy(_np(jp), _np(jq))
    _, qp = bridge.mlp_from_numpy(_np(jp), _np(jq), pack=True)
    return {"jpeu": jpeu, "jp": jp, "jq": jq, "peu": peu, "p": p, "q": q,
            "qp": qp}


def _quant(m, which):
    """(reference quant, port quant) of a route: exact, RMCM (plain
    product of the quant tree), RMCM packed (the K3 route's tree)."""
    return {"f32": (None, None), "rmcm": (m["jq"], m["q"]),
            "packed": (m["jq"], m["qp"])}[which]


TOL = {"f32": 1e-5, "rmcm": 5e-3, "packed": 5e-3}


# ------------------------------------------------------------------ SDF ----
def test_sdf_decls_match_reference(sdf_model):
    a = jsdf.sdf_decls(sdf_model["jpeu"], widths=WIDTHS)
    b = sdf.sdf_decls(sdf_model["peu"], widths=WIDTHS)
    assert sdf_model["peu"].out_dim == sdf_model["jpeu"].out_dim == 131
    assert {k: tuple(v["w"].shape) for k, v in a.items()} == \
        {k: tuple(v["w"].shape) for k, v in b.items()}


@pytest.mark.parametrize("route", ["f32", "rmcm", "packed"])
def test_sdf_eval_matches_reference(sdf_model, route):
    m = sdf_model
    jq, q = _quant(m, route)
    pts = RNG.uniform(-1.2, 1.2, size=(7, 9, 3)).astype(np.float32)
    a = jsdf.sdf_eval(m["jpeu"], m["jp"], jnp.asarray(pts), quant=jq)
    b = sdf.sdf_eval(m["peu"], m["p"], torch.from_numpy(pts), quant=q)
    assert b.shape == (7, 9)
    _close(a, b, TOL[route])


def test_sdf_packed_route_is_the_plain_product(sdf_model):
    """On the CPU a packed layer computes the unpacked tree's product bit
    for bit: packing is lossless."""
    m = sdf_model
    pts = torch.from_numpy(RNG.uniform(-1, 1, size=(33, 3)).astype(
        np.float32))
    assert torch.equal(sdf.sdf_eval(m["peu"], m["p"], pts, quant=m["q"]),
                       sdf.sdf_eval(m["peu"], m["p"], pts, quant=m["qp"]))


@pytest.mark.parametrize("route", ["f32", "packed"])
def test_sdf_normal_matches_reference(sdf_model, route):
    """Finite-difference normals at eps 1e-2 (at the default 1e-4 the two
    frameworks' last-ulp differences in the distances are amplified
    10^4 times by the difference quotient)."""
    m = sdf_model
    jq, q = _quant(m, route)
    pts = RNG.uniform(-1, 1, size=(16, 3)).astype(np.float32)
    a = jsdf.sdf_normal(m["jpeu"], m["jp"], jnp.asarray(pts), eps=1e-2) \
        if jq is None else _jax_normal_q(m, pts, jq)
    b = sdf.sdf_normal(m["peu"], m["p"], torch.from_numpy(pts), eps=1e-2,
                       quant=q)
    assert b.shape == (16, 3)
    np.testing.assert_allclose(np.linalg.norm(b.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    _close(a, b, TOL[route])


def _jax_normal_q(m, pts, jq):
    """The reference's ``sdf_normal`` takes no quant tree: its estimator
    over ``sdf_eval(..., quant=jq)``, as written there."""
    eps = 1e-2
    x = jnp.asarray(pts)
    offs = jnp.eye(3, dtype=x.dtype) * eps
    f = lambda y: jsdf.sdf_eval(m["jpeu"], m["jp"], y, quant=jq)
    g = (jnp.stack([f(x + offs[i]) for i in range(3)], -1)
         - jnp.stack([f(x - offs[i]) for i in range(3)], -1)) / (2 * eps)
    return g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-9)


@pytest.mark.parametrize("route", ["f32", "packed"])
def test_eval_grid_matches_reference(sdf_model, route):
    m = sdf_model
    jq, q = _quant(m, route)
    a = jsdf.eval_grid(m["jpeu"], m["jp"], resolution=8, chunk=100) \
        if jq is None else jsdf.sdf_eval(
            m["jpeu"], m["jp"],
            jnp.stack(jnp.meshgrid(*[jnp.linspace(-1.0, 1.0, 8)] * 3,
                                   indexing="ij"), -1), quant=jq)
    b = sdf.eval_grid(m["peu"], m["p"], resolution=8, chunk=100, quant=q)
    assert b.shape == (8, 8, 8) and bool(torch.isfinite(b).all())
    _close(a, b, TOL[route])


def test_sphere_sdf_matches_reference():
    pts = RNG.normal(size=(10, 3)).astype(np.float32)
    a = jsdf.sphere_sdf(jnp.asarray(pts), radius=0.6, center=(0.1, 0, -0.2))
    b = sdf.sphere_sdf(torch.from_numpy(pts), radius=0.6,
                       center=(0.1, 0, -0.2))
    _close(a, b, 1e-6)


def _fit_sdf(steps: int = 300):
    """The reference test's SDF fit (``tests/test_plcore.py``) on the port:
    its PEU (rff_iso, 64 features, sigma 2) and initial weights (key 0)
    and its batches (1024 uniform points in [-1.2, 1.2]^3 from
    ``fold_in(PRNGKey(1), i)``), carried across as data; widths (64, 64),
    the port's Adam at lr 3e-3 (warmup 10, 500-step schedule, no decay)
    against a sphere of radius 0.5. Returns (peu, params, last loss)."""
    key = jax.random.PRNGKey(0)
    jpeu = JPEU("rff_iso", 3, n_features=64, key=key, sigma=2.0)
    decls = jsdf.sdf_decls(jpeu, widths=WIDTHS)
    peu = bridge.peu_from_numpy("rff_iso", 3, np.asarray(jpeu.A))
    params, _ = bridge.mlp_from_numpy(_np(jax_init_params(decls, key,
                                                          "float32")))
    batches = np.array(jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(1), i), (1024, 3),
        minval=-1.2, maxval=1.2))(jnp.arange(steps)))
    opt_cfg = AdamConfig(lr=3e-3, warmup_steps=10, total_steps=500,
                         weight_decay=0.0)
    opt = init_params(opt_state_decls(sdf.sdf_decls(peu, widths=WIDTHS),
                                      opt_cfg), torch.Generator())
    loss = None
    for i in range(steps):
        pts = torch.from_numpy(batches[i])
        target = sdf.sphere_sdf(pts, radius=0.5)
        leaves = {k: {n: t.requires_grad_(True) for n, t in v.items()}
                  for k, v in params.items()}
        flat = [t for v in leaves.values() for t in v.values()]
        loss = torch.mean(torch.square(sdf.sdf_eval(peu, leaves, pts)
                                       - target))
        it = iter(torch.autograd.grad(loss, flat))
        grads = {k: {n: next(it) for n in v} for k, v in leaves.items()}
        params = {k: {n: t.detach() for n, t in v.items()}
                  for k, v in leaves.items()}
        params, opt, _ = adam_update(opt_cfg, params, grads, opt)
    return peu, params, float(loss.detach())


@pytest.fixture(scope="module")
def fitted_sdf():
    return _fit_sdf()


def test_sdf_fit_reaches_the_references_bounds(fitted_sdf):
    """The reference test's protocol and bounds on the port: loss below
    2e-3, rays toward the origin hit at t = 1.5 within 0.1, the normal at
    the sphere's pole within 0.2 of (0, 0, -1)."""
    peu, params, loss = fitted_sdf
    assert loss < 2e-3, loss
    o = torch.tensor([[0.0, 0.0, -2.0]] * 4)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    t, hit = sdf.sphere_trace(peu, params, o, d, n_steps=96, t_max=4.0)
    assert bool(hit.all())
    np.testing.assert_allclose(t.numpy(), 1.5, atol=0.1)
    n = sdf.sdf_normal(peu, params, torch.tensor([[0.0, 0.0, -0.5]]))
    np.testing.assert_allclose(n[0].numpy(), [0, 0, -1], atol=0.2)


@pytest.mark.parametrize("route", ["f32", "packed"])
def test_sphere_trace_matches_reference(fitted_sdf, route):
    """The fitted SDF carried to the reference: both trace the same rays,
    t within 1e-4 and equal hit masks (rays at the sphere and rays that
    pass it by)."""
    peu, params, _ = fitted_sdf
    jpeu = JPEU("rff_iso", 3, n_features=64, key=jax.random.PRNGKey(0),
                sigma=2.0)
    jp = jax.tree.map(jnp.asarray, bridge.to_numpy(params))
    jq = q = None
    if route == "packed":
        jq = jr.quantize_tree(jp)
        q = mlp.pack_quant(bridge.to_torch(_np(jq)))
    aim = RNG.uniform(-0.3, 0.3, size=(24, 3)).astype(np.float32)
    aim[:6, :2] += 1.5                                 # misses
    o = np.tile(np.array([[0.0, 0.0, -2.0]], np.float32), (24, 1))
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ta, ha = jsdf.sphere_trace(jpeu, jp, jnp.asarray(o), jnp.asarray(d),
                               n_steps=64, t_max=4.0) if jq is None else \
        _jax_trace_q(jpeu, jp, jq, o, d)
    tb, hb = sdf.sphere_trace(peu, params, torch.from_numpy(o),
                              torch.from_numpy(d), n_steps=64, t_max=4.0,
                              quant=q)
    assert np.array_equal(np.asarray(ha), hb.numpy())
    assert hb[6:].all() and not hb[:6].any()
    np.testing.assert_allclose(np.asarray(ta), tb.numpy(), rtol=0, atol=1e-4)


def _jax_trace_q(jpeu, jp, jq, o, d):
    """The reference's ``sphere_trace`` body over ``sdf_eval(...,
    quant=jq)`` (its signature takes no quant tree)."""
    t = jnp.zeros(o.shape[0], jnp.float32)
    done = jnp.zeros(o.shape[0], bool)
    for _ in range(64):
        dist = jsdf.sdf_eval(jpeu, jp, o + t[:, None] * d, quant=jq)
        t_new = jnp.where(done, t, jnp.minimum(t + jnp.abs(dist), 4.0))
        done = done | (jnp.abs(dist) < 1e-3) | (t_new >= 4.0)
        t = t_new
    return t, done & (t < 4.0)


# ------------------------------------------------------------------ SLF ----
def test_make_slf_peu_matches_reference(slf_model):
    a, b = slf_model["jpeu"], slf_model["peu"]
    assert (b.mode, b.in_dim, b.out_dim) == (a.mode, a.in_dim, a.out_dim)
    assert np.array_equal(np.asarray(a.A), b.A.numpy())
    # drawn from a generator: per-axis sigmas 8 (position) and 1 (direction)
    g = slf.make_slf_peu(torch.Generator().manual_seed(0), n_features=4096)
    std = g.A.std(dim=1)
    np.testing.assert_allclose(std.numpy(), [8, 8, 8, 1, 1, 1], rtol=0.05)


@pytest.mark.parametrize("route", ["f32", "rmcm", "packed"])
def test_slf_eval_and_loss_match_reference(slf_model, route):
    m = slf_model
    jq, q = _quant(m, route)
    pts = RNG.uniform(-1, 1, size=(40, 3)).astype(np.float32)
    dirs = RNG.normal(size=(40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb = RNG.uniform(size=(40, 3)).astype(np.float32)
    a = jslf.slf_eval(m["jpeu"], m["jp"], jnp.asarray(pts),
                      jnp.asarray(dirs), quant=jq)
    b = slf.slf_eval(m["peu"], m["p"], torch.from_numpy(pts),
                     torch.from_numpy(dirs), quant=q)
    assert b.shape == (40, 3) and bool(((b >= 0) & (b <= 1)).all())
    _close(a, b, TOL[route])
    la = jslf.slf_loss(m["jpeu"], m["jp"], {
        "points": jnp.asarray(pts), "dirs": jnp.asarray(dirs),
        "rgb": jnp.asarray(rgb)}, quant=jq)
    lb = slf.slf_loss(m["peu"], m["p"], {
        "points": torch.from_numpy(pts), "dirs": torch.from_numpy(dirs),
        "rgb": torch.from_numpy(rgb)}, quant=q)
    _close(la, lb, TOL[route])


def test_slf_loss_gradients_match_reference(slf_model):
    """One autograd gradient of ``slf_loss`` against ``jax.grad``."""
    m = slf_model
    pts = RNG.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    dirs = RNG.normal(size=(64, 3)).astype(np.float32)
    rgb = RNG.uniform(size=(64, 3)).astype(np.float32)
    gj = jax.grad(jslf.slf_loss, argnums=1)(m["jpeu"], m["jp"], {
        "points": jnp.asarray(pts), "dirs": jnp.asarray(dirs),
        "rgb": jnp.asarray(rgb)})
    leaves = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
              for k, v in m["p"].items()}
    slf.slf_loss(m["peu"], leaves, {
        "points": torch.from_numpy(pts), "dirs": torch.from_numpy(dirs),
        "rgb": torch.from_numpy(rgb)}).backward()
    for k, v in leaves.items():
        for n, t in v.items():
            ref = np.asarray(gj[k][n])
            np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-4,
                                       atol=1e-5 * max(1.0, np.abs(ref).max()))


# ------------------------------------------------------- K3 route packing --
@pytest.mark.parametrize("k", [259, 262])
@pytest.mark.parametrize("n", [1, 3, 256])
def test_pack_round_trips_at_the_workload_shapes(k, n):
    """K = PEU.out_dim of the SDF (259) and the SLF (262), not multiples of
    8, and the heads' N = 1 and 3: ``unpack(pack(q)) == q`` exactly, the
    sign bytes ceil(K/8) rows, and the same bits as the reference's
    quantization of the same weights."""
    w = RNG.normal(size=(k, n)).astype(np.float32)
    q = rmcm.quantize(torch.from_numpy(w))
    p = rmcm.pack(q)
    assert tuple(p["sign_bits"].shape) == (-(-k // 8), n)
    u = rmcm.unpack(p)
    for key in ("mag", "sign", "scale"):
        assert torch.equal(u[key], q[key]), key
    jq = jr.quantize(jnp.asarray(w))
    assert np.array_equal(np.asarray(jq["mag"]), q["mag"].numpy())
    assert np.array_equal(np.asarray(jq["sign"]), q["sign"].numpy())


def test_pack_quant_covers_every_layer(sdf_model):
    """``pack_quant`` packs each layer's weight once and keeps its bias."""
    qp = sdf_model["qp"]
    assert sorted(qp) == ["l0", "l1", "l2"]
    assert qp["l0"]["w"]["k"] == 131 and qp["l2"]["w"]["mag"].shape[1] == 1
    for name, layer in qp.items():
        assert set(layer["w"]) == {"mag", "sign_bits", "scale", "k"}
        assert torch.equal(layer["b"], sdf_model["q"][name]["b"])
