"""make_render_step on a one-rank host mesh, PlcoreModel, and the small
leftovers of the port (``kernels.ref.fused_render_ref``,
``configs.get_nerf_config``), against the JAX package on its weights.

Tolerances: the sharded plain route equals the port's unsharded
``render_rays`` bit for bit (one rank renders every ray) and the
reference's within 1e-3 (the two packages' renders: the importance
resampler turns last-ulp differences of the coarse pass into moved fine
samples); the kernel route (K1's plain version on the CPU) within 5e-3,
the kernel-vs-XLA entry of the reference's parity matrix. The composed-
core oracle equals the reference's within 1e-5, and K1 is held to it at
1e-5, as ``tests/test_kernels.py`` holds the reference's kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_nerf_config as jax_get_nerf_config
from repro.configs.nerf_icarus import NerfConfig as JNerfConfig
from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core import rmcm as jrmcm
from repro.core.plcore import plcore_decls as jax_plcore_decls
from repro.core.plcore import render_rays as jax_render_rays
from repro.kernels.ref import fused_render_ref as jax_fused_render_ref
from repro.models.params import init_params as jax_init_params

from repro_torch import bridge
from repro_torch.configs import get_nerf_config
from repro_torch.configs.nerf_icarus import NerfConfig, tiny
from repro_torch.core import plcore, sampling
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import fused_render_ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.sharding import Rules


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _ref_params(cfg_j, seed: int):
    return jax_init_params(jax_plcore_decls(cfg_j), jax.random.PRNGKey(seed),
                           "float32")


def _to_t(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree))


def _rays(seed: int, R: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32) * 0.1
    d = rng.normal(size=(R, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _t_deltas(seed: int, R: int, N: int):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(size=(R, N)), axis=-1).astype(np.float32) * 4 + 2
    return t, sampling.deltas_from_t(_t(t)).numpy()


# ------------------------------------------------------------ render step --
def test_render_step_on_a_host_mesh():
    from torch.distributed.tensor import DTensor

    cfg_j, cfg = jax_tiny(), tiny()
    p_j = _ref_params(cfg_j, 0)
    p = _to_t(p_j)
    o, d = _rays(1, 96)
    ref = np.asarray(jax.jit(jax_render_rays, static_argnums=0)(
        cfg_j, p_j, jnp.asarray(o), jnp.asarray(d))["rgb"])
    ours = plcore.render_rays(cfg, p, _t(o), _t(d))["rgb"]
    with make_host_mesh(device="cpu") as mesh:
        plain = plcore.make_render_step(cfg, mesh, Rules())(p, _t(o), _t(d))
        kern = plcore.make_render_step(cfg, mesh, Rules(), use_kernel=True)(
            p, _t(o), _t(d))
        assert isinstance(plain, DTensor) and plain.shape == (96, 3)
        assert [str(x) for x in plain.placements] == ["S(0)", "R"]
        model = plcore.PlcoreModel(cfg)
        rs = model.render_step(p, {"rays_o": _t(o), "rays_d": _t(d)})
    assert not dist.is_initialized()
    assert torch.equal(plain.to_local(), ours)
    torch.testing.assert_close(plain.to_local(), _t(ref), atol=1e-3, rtol=0)
    torch.testing.assert_close(kern.to_local(), ours, atol=5e-3, rtol=0)
    assert torch.equal(rs, ours)


def test_plcore_model_specs():
    model = plcore.PlcoreModel(tiny())
    specs = model.input_specs(160000)
    assert sorted(specs) == ["rays_d", "rays_o"]
    assert all(s.device.type == "meta" and tuple(s.shape) == (160000, 3)
               and s.dtype == torch.float32 for s in specs.values())
    assert model.input_logical() == {"rays_o": ("batch", None),
                                     "rays_d": ("batch", None)}


# -------------------------------------------------------- fused_render_ref --
def _ref_pair(cfg_j, cfg, net: str, seed: int, R: int, N: int, quant=False):
    p_j = _ref_params(cfg_j, seed)[net]
    q_j = jrmcm.quantize_tree(p_j) if quant else None
    o, d = _rays(seed + 1, R)
    t, dl = _t_deltas(seed + 2, R, N)
    a_rgb, a_aux = jax.jit(jax_fused_render_ref, static_argnums=0)(
        cfg_j, p_j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
        jnp.asarray(dl), quant=q_j)
    args = (cfg, _to_t(p_j), _t(o), _t(d), _t(t), _t(dl))
    q = _to_t(q_j) if quant else None
    b_rgb, b_aux = fused_render_ref(*args, quant=q)
    torch.testing.assert_close(b_rgb, _t(a_rgb), atol=1e-5, rtol=0)
    for k in ("weights", "acc"):
        torch.testing.assert_close(b_aux[k], _t(a_aux[k]), atol=1e-5, rtol=0)
    k_rgb, k_aux = kops.fused_render(*args, quant=q)
    torch.testing.assert_close(k_rgb, b_rgb, atol=1e-5, rtol=0)
    for k in ("weights", "acc"):
        torch.testing.assert_close(k_aux[k], b_aux[k], atol=1e-5, rtol=0)


@pytest.mark.parametrize("R,N", [(8, 16), (40, 32), (16, 33), (64, 192)])
def test_fused_render_ref_exact(R, N):
    _ref_pair(jax_tiny(), tiny(), "fine", 0, R, N)


def test_fused_render_ref_quantized():
    _ref_pair(jax_tiny(), tiny(), "fine", 3, 24, tiny().n_coarse, quant=True)


@pytest.mark.parametrize("kw", [
    dict(trunk_layers=2, trunk_width=32, skip_at=(1,), color_width=16,
         pos_freqs=4, dir_freqs=2, n_coarse=8, n_fine=8),
    dict(trunk_layers=5, trunk_width=64, skip_at=(2, 4), color_width=32,
         pos_freqs=6, dir_freqs=3, n_coarse=16, n_fine=16)])
def test_fused_render_ref_config_sweep(kw):
    _ref_pair(JNerfConfig(**kw), NerfConfig(**kw), "coarse", 6, 16,
              kw["n_coarse"])


@pytest.mark.parametrize("variant", ["full", "tiny"])
def test_get_nerf_config_matches_reference(variant):
    ours, ref = get_nerf_config(variant), jax_get_nerf_config(variant)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours == NerfConfig()) == (variant == "full")
