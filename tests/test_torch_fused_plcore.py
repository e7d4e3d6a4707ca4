"""The port's fused PLCore kernels (K1, K2): plain versions against the
reference's Pallas kernels on the CPU (the CUDA kernels against the plain
versions on the card are in ``test_torch_kernels_gpu.py``).

On the CPU the wrappers run the plain versions (a CPU tensor never reaches
a kernel). The reference side runs as its own tests run it:
``fused_render`` through the Pallas interpreter, ``fused_render_two_pass``
through its grid emulator. Tolerances are the reference's parity regimes:
1e-3 for the fp32 chain (the importance resampler turns last-ulp
differences into moved samples), 5e-3 with RMCM or ERT, 1e-2 on depth.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core import rmcm as jr, sampling as js
from repro.core.plcore import plcore_decls
from repro.kernels import ops as jops
from repro.models.params import init_params

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core import plcore
from repro_torch.kernels import fused_plcore, ops, ref

R = 48


@pytest.fixture(scope="module")
def nets():
    params = init_params(plcore_decls(jax_tiny()), jax.random.PRNGKey(0),
                         "float32")
    quant = {n: jr.quantize_tree(params[n]) for n in ("coarse", "fine")}
    return params, quant


def _rays(n=R, seed=5):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    o[:, :2] = rng.uniform(-0.3, 0.3, (n, 2))
    d = rng.normal(0, 0.25, (n, 3)).astype(np.float32)
    d[:, 2] -= 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _packed(params, quant, quantized):
    """(reference layout, port layout) of both networks."""
    out_j, out_t = {}, {}
    for n in ("coarse", "fine"):
        q = quant[n] if quantized else None
        out_j[n] = jops.stack_plcore_weights(jax_tiny(), params[n], q)
        out_t[n] = ops.stack_plcore_weights(
            tiny(), bridge.to_torch(jax.tree.map(np.asarray, params[n])),
            bridge.to_torch(jax.tree.map(np.asarray, q)) if quantized else None)
    return out_j, out_t


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=tol)


# ------------------------------------------------------------------ K1 -----
@pytest.mark.parametrize("quantized,masked", [(False, False), (True, False),
                                              (False, True)])
def test_plain_k1_matches_reference(nets, quantized, masked):
    pj, pt = _packed(*nets, quantized)
    o, d = _rays()
    rng = np.random.default_rng(6)
    t = np.sort(rng.uniform(2, 6, (R, 16)), -1).astype(np.float32)
    dl = np.array(js.deltas_from_t(jnp.asarray(t)))
    alive = None
    if masked:   # one all-dead reference tile (rt = 8), the rest mixed
        alive = (rng.uniform(size=R) > 0.4).astype(np.float32)
        alive[:8] = 0.0
    rgb_j, aux_j = jops.fused_render(
        jax_tiny(), None, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
        jnp.asarray(dl), packed=pj["fine"], rt=8, interpret=True,
        alive=None if alive is None else jnp.asarray(alive))
    rgb_t, aux_t = ops.fused_render(
        tiny(), None, *map(torch.from_numpy, (o, d, t, dl)),
        packed=pt["fine"], alive=None if alive is None else torch.from_numpy(alive))
    tol = 5e-3 if quantized else 1e-3
    live = np.ones(R, bool) if alive is None else alive > 0
    _close(np.asarray(rgb_j)[live], rgb_t[live], tol)
    _close(np.asarray(aux_j["weights"])[live], aux_t["weights"][live], tol)
    _close(np.asarray(aux_j["acc"])[live], aux_t["acc"][live], tol)
    # dead rays come back as zeros (the reference zeroes all-dead tiles)
    assert not rgb_t[~live].any() and not aux_t["weights"][~live].any()
    _close(np.asarray(rgb_j)[:8][~live[:8]], rgb_t[:8][~live[:8]], 0.0)


# ------------------------------------------------------------------ K2 -----
CASES = {"f32": (False, 0.0, False), "rmcm": (True, 0.0, False),
         "ert": (False, 0.05, False), "rmcm_ert": (True, 0.05, False),
         "alive": (False, 0.0, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k2_matches_reference(nets, case):
    quantized, eps, masked = CASES[case]
    pj, pt = _packed(*nets, quantized)
    o, d = _rays()
    alive = None
    if masked:
        alive = (np.random.default_rng(7).uniform(size=R) > 0.5).astype(np.float32)
    out_j = jops.fused_render_two_pass(
        jax_tiny(), pj, jnp.asarray(o), jnp.asarray(d), ert_eps=eps,
        interpret=True, alive=None if alive is None else jnp.asarray(alive))
    out_t = ops.fused_render_two_pass(
        tiny(), pt, torch.from_numpy(o), torch.from_numpy(d), ert_eps=eps,
        alive=None if alive is None else torch.from_numpy(alive))
    tol = 5e-3 if (quantized or eps > 0) else 1e-3
    for k in ("rgb", "rgb_coarse", "acc", "acc_coarse"):
        _close(out_j[k], out_t[k], tol)
    _close(out_j["depth"], out_t["depth"], 1e-2)
    if eps > 0:   # the case really mixes terminated and live rays
        dead = out_t["acc_coarse"] >= ref.ert_threshold(eps)
        assert 0 < int(dead.sum()) < R


def test_plain_k2_tile_size_invariant(nets):
    _, pt = _packed(*nets, False)
    o, d = map(torch.from_numpy, _rays())
    base = ops.fused_render_two_pass(tiny(), pt, o, d, rt=R)
    for rt in (8, 20):
        out = ops.fused_render_two_pass(tiny(), pt, o, d, rt=rt)
        for k in base:
            torch.testing.assert_close(out[k], base[k], rtol=0, atol=1e-5)


def test_plain_k2_white_background_is_the_callers_composite(nets):
    """K2 with ``white_bkgd`` gives both rgb outputs composited onto white
    with their own acc, bit for bit ``volume.white_background``; the
    rest as without."""
    from repro_torch.core import volume
    _, pt = _packed(*nets, True)
    o, d = map(torch.from_numpy, _rays())
    base = ops.fused_render_two_pass(tiny(), pt, o, d, rt=R)
    white = ops.fused_render_two_pass(tiny(), pt, o, d, rt=R,
                                      white_bkgd=True)
    assert torch.equal(white["rgb"],
                       volume.white_background(base["rgb"], base["acc"]))
    assert torch.equal(white["rgb_coarse"], volume.white_background(
        base["rgb_coarse"], base["acc_coarse"]))
    for k in ("acc", "acc_coarse", "depth"):
        assert torch.equal(white[k], base[k])


def test_k2_sample_rows_built_once_and_match_reference():
    cfg = tiny()
    t_row, u_row = ops.sample_rows(cfg, "cpu")
    again = ops.sample_rows(cfg, torch.device("cpu"))
    assert again[0] is t_row and again[1] is u_row
    jc = jax_tiny()
    np.testing.assert_array_equal(
        t_row.numpy(), np.asarray(js.stratified(jc.near, jc.far, jc.n_coarse,
                                                (1,), None)))
    np.testing.assert_array_equal(u_row.numpy(),
                                  np.asarray(js.det_u(jc.n_fine)))


def test_dispatch_count_ticks_once_per_fused_call(nets):
    _, pt = _packed(*nets, False)
    o, d = map(torch.from_numpy, _rays(16))
    n0 = ops.dispatch_count()
    plcore.render_rays(tiny(), None, o, d, use_kernel=True,
                       fuse_two_pass=True, packed=pt)
    assert ops.dispatch_count() - n0 == 1
    n1 = ops.dispatch_count()
    plcore.render_rays(tiny(), None, o, d, use_kernel=True, packed=pt)
    assert ops.dispatch_count() - n1 == 2
    # the CPU path never launches a kernel
    assert fused_plcore.LAUNCHES == {"fused_plcore_call": 0,
                                     "two_pass_plcore_call": 0}


@pytest.mark.parametrize("n,paired", [
    (64, True), (192, True), (320, True),       # N = 64 mod 128
    (16, False), (32, False), (8, False),       # tiny(), the sweep
    (72, False), (96, False),                   # ASDR budgets Nc + 8, + 32
    (128, False), (256, False)])                # whole chunks already
def test_k2_pairs_a_pass_only_where_its_rows_then_fill_the_chunks(n, paired):
    """A pass of n samples a ray pairs when n fills whole half chunks and
    two rays' rows fill fewer 128-row chunks than two walks of one."""
    assert fused_plcore.pairs(n) is paired
    if n % 64 == 0:
        assert paired == (-(-2 * n // 128) < 2 * -(-n // 128))


@pytest.mark.parametrize("nc,nf,paired", [
    (64, 128, True), (64, 8, True), (64, 32, True), (64, 64, True),
    (16, 16, False), (8, 8, False), (128, 64, True), (128, 128, False)])
def test_k2_takes_rays_in_pairs_where_a_pass_pairs(nc, nf, paired):
    assert fused_plcore.k2_pairs(nc, nf) is paired


@pytest.mark.parametrize("n_rays,slots,want,want_paired", [
    (4096, 132, 3, 2),        # 1,366 blocks in 10.35 waves -> 2,048 / 15.5
    (16384, 132, 15, 14),     # 14: 1,171 blocks in 9 waves, 16: 1,024 in 8
    (8192, 132, 7, 8),        # 8: 1,024 blocks in 8 waves, 6: 1,366 in 11
    (4096, 264, 1, 2),        # two blocks an SM
    (512, 132, 1, 2),
    (65536, 132, 62, 62)])    # already even
def test_ray_tile_is_even_for_k2_where_it_pairs(n_rays, slots, want,
                                                 want_paired):
    """K1, and K2 where no pass pairs, keep the tile of about eight waves;
    K2 taking its rays in pairs gets an even tile, the even neighbour
    whose grid takes fewer ray walks in whole waves."""
    assert ops.ray_tile(n_rays, slots) == want
    got = ops.ray_tile(n_rays, slots, pairs=True)
    assert got == want_paired and got % 2 == 0


def test_pick_ray_tile_on_the_cpu_keeps_the_plain_batch():
    cpu = torch.device("cpu")
    assert ops.pick_ray_tile(4096, cpu) == ops.PLAIN_TILE
    assert ops.pick_ray_tile(4096, cpu, pairs=True) == ops.PLAIN_TILE
