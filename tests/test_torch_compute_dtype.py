"""``NerfConfig.compute_dtype`` on the port's plain route, against the
reference.

The reference casts the encodings and the weights to the compute dtype
before the MLP engine and integrates the VRU in f32
(``repro.core.plcore._eval_pass``), and so do ASDR's trunk-row and
dead-row programs (``repro.core.pipeline._trunk_rows_fn``/``_recon_fn``).
On tiny() weights from ``PRNGKey(0)`` and 64 random rays (deterministic
sampling), the reference's own bf16 render is about 3.6e-3 from its f32
render; a port that ignores the field renders f32 and lands there. The
port in bf16 is held to the reference in bf16 well inside that gap: the
coarse pass (no resampler to amplify an ulp) within 1e-4, the full
render at the f32 case's tolerance (1e-3). The f32 case stays at its
tolerances. The dead-row program is held to the reference run op by op
(``jax.disable_jit``), as the LM tests hold bf16: jitted, XLA fuses the
bf16 colour branch with f32 intermediates and moves its own pixels by
1.5e-3, while the port equals the op-by-op run to 1.2e-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core import pipeline as jp
from repro.core import plcore as jpl
from repro.core import rmcm as jr
from repro.models.params import init_params

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core import pipeline as P
from repro_torch.core import plcore

DTYPES = ["float32", "bfloat16"]
# the reference's bf16-vs-f32 gap on these rays is ~3.6e-3
COARSE_TOL = 1e-4
RENDER_TOL = 1e-3


def _cfgs(dtype: str):
    return (dataclasses.replace(jax_tiny(), compute_dtype=dtype),
            dataclasses.replace(tiny(), compute_dtype=dtype))


def _to_t(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def weights():
    return init_params(jpl.plcore_decls(jax_tiny()), jax.random.PRNGKey(0),
                       "float32")


def _rays(R: int = 64):
    rng = np.random.default_rng(0)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32) \
        - 4.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_render_follows_compute_dtype(weights, dtype):
    cj, ct = _cfgs(dtype)
    o, d = _rays()
    want = jpl.render_rays(cj, weights, jnp.asarray(o), jnp.asarray(d))
    got = plcore.render_rays(ct, _to_t(weights), torch.from_numpy(o),
                             torch.from_numpy(d))
    for k in ("rgb_coarse", "rgb", "acc", "depth"):
        assert got[k].dtype == torch.float32, k
    np.testing.assert_allclose(got["rgb_coarse"].numpy(),
                               np.asarray(want["rgb_coarse"]), rtol=0,
                               atol=COARSE_TOL)
    for k in ("rgb", "acc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=RENDER_TOL, err_msg=k)


def test_bf16_is_not_the_f32_render(weights):
    """The gap the tolerances sit inside: the reference's bf16 coarse pass
    is far (> 10x COARSE_TOL) from the port's f32 one."""
    o, d = _rays()
    want = jpl.render_rays(_cfgs("bfloat16")[0], weights, jnp.asarray(o),
                           jnp.asarray(d))
    f32 = plcore.render_rays(tiny(), _to_t(weights), torch.from_numpy(o),
                             torch.from_numpy(d))
    gap = np.abs(f32["rgb_coarse"].numpy()
                 - np.asarray(want["rgb_coarse"])).max()
    assert gap > 10 * COARSE_TOL, gap


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_asdr_rows_follow_compute_dtype(weights, dtype, quantized):
    """``trunk_rows`` and ``recon_rows`` in the compute dtype against the
    reference's trunk-row and dead-row programs, f32 and RMCM weights."""
    cj, ct = _cfgs(dtype)
    quant = {n: jr.quantize_tree(weights[n]) for n in ("coarse", "fine")} \
        if quantized else None
    jpp = jp.PackedPlcore(cj, weights, quant=quant)
    tpp = P.PackedPlcore(ct, _to_t(weights),
                         quant=None if quant is None else _to_t(quant),
                         device="cpu")
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    want = jp.trunk_rows(jpp, pts, chunk=128)
    got = P.trunk_rows(tpp, pts, chunk=128)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # dead rows rebuilt from those rows: 24 rays of 16 coarse samples
    o, d = _rays(24)
    inv = rng.integers(0, pts.shape[0], (24, ct.n_coarse))
    t_row = np.linspace(ct.near, ct.far, ct.n_coarse).astype(np.float32)
    g = want[inv]
    with jax.disable_jit():      # op by op: see the module docstring
        ref = jp._recon_fn(cj)(
            weights["coarse"], (quant or {}).get("coarse"),
            jnp.asarray(g[..., 0]), jnp.asarray(g[..., 1:]), jnp.asarray(d),
            jnp.asarray(np.broadcast_to(t_row, (24, t_row.size))))
    ours = P.recon_rows(tpp, want, inv, d, t_row)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=COARSE_TOL)
