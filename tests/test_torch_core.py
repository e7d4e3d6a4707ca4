"""Core modules of the PyTorch port against the reference package.

Inputs come from numpy with a fixed seed and go through the reference
function and its port; results agree to 1e-5 (float32 sums taken in
another order), and the port's deterministic resampler forms agree with
its host forms exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.nerf_icarus import NerfConfig, tiny as jax_tiny
from repro.core import encoding as je, mlp as jm, rmcm as jr
from repro.core import sampling as js, volume as jv
from repro.models.params import init_params

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core import encoding, mlp, rmcm, sampling, volume

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(1234)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), **(kw or TOL))


@pytest.mark.parametrize("fn", ["nerf_encoding", "nerf_encoding_double_angle"])
def test_encoding_matches_reference(fn):
    x = RNG.uniform(-3, 3, (7, 5, 3)).astype(np.float32)
    _close(getattr(je, fn)(jnp.asarray(x), 6),
           getattr(encoding, fn)(torch.from_numpy(x), 6))


@pytest.mark.parametrize("quantized", [False, True])
def test_nerf_mlp_apply_matches_reference(quantized):
    cfg_j, cfg_t = jax_tiny(), tiny()
    p = init_params(jm.nerf_mlp_decls(cfg_j), jax.random.PRNGKey(2), "float32")
    q = jr.quantize_tree(p) if quantized else None
    pe_pos = RNG.normal(size=(6, 9, cfg_t.pos_enc_dim)).astype(np.float32)
    pe_dir = RNG.normal(size=(6, 1, cfg_t.dir_enc_dim)).astype(np.float32)
    sj, cj = jm.nerf_mlp_apply(cfg_j, p, jnp.asarray(pe_pos),
                               jnp.asarray(pe_dir), quant=q)
    to_t = lambda t: bridge.to_torch(jax.tree.map(np.asarray, t))  # noqa
    st, ct = mlp.nerf_mlp_apply(cfg_t, to_t(p), torch.from_numpy(pe_pos),
                                torch.from_numpy(pe_dir),
                                quant=to_t(q) if quantized else None)
    _close(sj, st, rtol=1e-5, atol=1e-4)   # O(10) raw densities
    _close(cj, ct)


def test_render_parallel_matches_reference():
    sigma = RNG.normal(0, 3, (5, 20)).astype(np.float32)
    rgb = RNG.uniform(size=(5, 20, 3)).astype(np.float32)
    t = np.sort(RNG.uniform(2, 6, (5, 20)), -1).astype(np.float32)
    dl = np.array(js.deltas_from_t(jnp.asarray(t)))
    oj, aj = jv.render_parallel(jnp.asarray(sigma), jnp.asarray(rgb),
                                jnp.asarray(dl))
    ot, at = volume.render_parallel(torch.from_numpy(sigma),
                                    torch.from_numpy(rgb), torch.from_numpy(dl))
    _close(oj, ot)
    for k in ("weights", "transmittance", "acc"):
        _close(aj[k], at[k])
    _close(jv.composite_depth(aj["weights"], jnp.asarray(t)),
           volume.composite_depth(at["weights"], torch.from_numpy(t)),
           rtol=1e-5, atol=1e-4)
    _close(jv.white_background(oj, aj["acc"]),
           volume.white_background(ot, at["acc"]))


def _coarse_set(rows=9, m=17):
    t = np.sort(RNG.uniform(size=(rows, m)), -1).astype(np.float32) * 4 + 2
    w = RNG.uniform(size=(rows, m)).astype(np.float32)
    return t, w


@pytest.mark.parametrize("det", [False, True])
def test_importance_matches_reference(det):
    t, w = _coarse_set()
    if det:
        ref = js.importance_det(jnp.asarray(t), jnp.asarray(w), 12)
        got = sampling.importance_det(torch.from_numpy(t), torch.from_numpy(w), 12)
    else:
        ref = js.importance(jnp.asarray(t), jnp.asarray(w), 12, key=None)
        got = sampling.importance(torch.from_numpy(t), torch.from_numpy(w), 12)
    _close(ref, got)


def test_importance_det_equals_host_form_exactly():
    t, w = map(torch.from_numpy, _coarse_set())
    assert torch.equal(sampling.importance(t, w, 12),
                       sampling.importance_det(t, w, 12))
    w0 = torch.zeros(4, 17)
    w0[:, 8] = 1.0                  # a single hot bin: duplicate samples
    assert torch.equal(sampling.importance(t[:4], w0, 12),
                       sampling.importance_det(t[:4], w0, 12))


def test_merge_sorted_ranks_matches_reference_and_sort():
    # quantized to force ties within and across the two sets
    a = np.sort(np.round(RNG.uniform(size=(6, 10)) * 8) / 8, -1).astype(np.float32)
    b = np.sort(np.round(RNG.uniform(size=(6, 14)) * 8) / 8, -1).astype(np.float32)
    got = sampling.merge_sorted_ranks(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        np.asarray(js.merge_sorted_ranks(jnp.asarray(a), jnp.asarray(b))),
        got.numpy())
    assert torch.equal(got, sampling.merge_sorted(torch.from_numpy(a),
                                                  torch.from_numpy(b)))


def test_stratified_and_deltas_match_reference():
    _close(js.stratified(2.0, 6.0, 16, (3,), None),
           sampling.stratified(2.0, 6.0, 16, (3,)))
    t = np.sort(RNG.uniform(2, 6, (4, 11)), -1).astype(np.float32)
    _close(js.deltas_from_t(jnp.asarray(t)),
           sampling.deltas_from_t(torch.from_numpy(t)))
    g = torch.Generator().manual_seed(0)
    tj = sampling.stratified(2.0, 6.0, 16, (5,), g)
    assert bool((tj.diff(dim=-1) >= 0).all())
    assert bool(((tj >= 2.0) & (tj <= 6.0)).all())


@pytest.mark.parametrize("n", [16, 64, 128, 192])
def test_sample_grids_equal_reference_bit_for_bit(n):
    """``det_u`` and the coarse bin midpoints at the full config's near/far
    equal the reference's float32 values exactly (``torch.linspace``
    rounds some points differently)."""
    np.testing.assert_array_equal(sampling.det_u(n).numpy(),
                                  np.asarray(js.det_u(n)))
    near, far = NerfConfig().near, NerfConfig().far
    np.testing.assert_array_equal(
        sampling.stratified(near, far, n, (1,)).numpy(),
        np.asarray(js.stratified(near, far, n, (1,), None)))
