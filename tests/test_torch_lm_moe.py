"""LM serving in the port, MoE family (moonshot, kimi-k2), against the
reference on the same weights: per arch ``loss``, prefill, cache and
teacher-forced decode, the reference's prefill/decode consistency, and the
capacity drop at ``capacity_factor=0.5`` (tests/test_models.py's tight
config): the same kept (token, choice) pairs, ``y`` at 1e-5, ``aux`` at
1e-6. Tolerances in ``tests/_torch_lm_common.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models.model_zoo import build_model as jax_build
from repro.models.params import init_params as jax_init

from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.models import moe

from _torch_lm_common import (check_arch, check_bf16_op_by_op,
                              check_consistency, close,
                              one_torch_thread)  # noqa: F401

MOE = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"]


def _tight(cfg):
    return cfg.replace(moe=cfg.moe.__class__(
        n_experts=8, experts_per_token=2, d_ff_expert=32,
        n_shared_experts=0, d_ff_dense=128, first_k_dense=0,
        capacity_factor=0.5))


def _reference_keep(cfg, probs):
    """The reference's dispatch (``_moe_apply_dense``, the lines from the
    top-k to ``keep``) on its router probabilities:
    the sort order of the (token, choice) pairs and their keep mask."""
    m = cfg.moe
    T = probs.shape[0]
    _, expert_ids = jax.lax.top_k(probs, m.experts_per_token)
    flat_e = expert_ids.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, jnp.arange(m.n_experts,
                                                  dtype=sorted_e.dtype))
    seg_pos = jnp.arange(T * m.experts_per_token) - first[sorted_e]
    keep = seg_pos < jmoe.capacity(cfg, T)
    return np.asarray(order), np.asarray(keep)


@pytest.mark.parametrize("arch", MOE)
def test_matches_reference(arch):
    check_arch(arch)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_consistency(arch):
    check_consistency(arch)


def test_bf16_smoke_matches_reference_op_by_op():
    check_bf16_op_by_op("moonshot-v1-16b-a3b")


@pytest.mark.parametrize("seed", [1, 2])
def test_capacity_drop_matches_reference(seed):
    jcfg = _tight(jax_smoke_config("moonshot-v1-16b-a3b"))
    cfg = _tight(smoke_config("moonshot-v1-16b-a3b"))
    jp = jax_init(jax_build(jcfg).param_decls(), jax.random.PRNGKey(0),
                  "float32")
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    lp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jlp))
    x = np.random.default_rng(seed).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)

    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model)
                            @ jlp["router"], axis=-1)
    order, keep = _reference_keep(jcfg, jprobs)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, cfg.d_model)
                          @ lp["router"], dim=-1)
    r = moe.route(cfg, probs)
    assert r["capacity"] == jmoe.capacity(jcfg, 64) < 2 * 64 // 8 + 8
    np.testing.assert_array_equal(r["order"].numpy(), order)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    np.testing.assert_array_equal(r["dest"].numpy() < 8 * r["capacity"], keep)
    assert 0 < keep.sum() < keep.size            # genuinely tight

    jy, jaux = jmoe.moe_apply(jcfg, jlp, jnp.asarray(x))
    y, aux = moe.moe_apply(cfg, lp, torch.from_numpy(x))
    close(jy, y, 1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)
    assert float(aux) > 0.0 and bool(torch.isfinite(y).all())


def test_top_k_ties_take_the_lower_expert():
    """``lax.top_k`` breaks a tie by the lower index; so does ``route``."""
    cfg = _tight(smoke_config("moonshot-v1-16b-a3b"))
    probs = torch.full((3, 8), 0.125)
    r = moe.route(cfg, probs)
    np.testing.assert_array_equal(r["expert_ids"].numpy(), [[0, 1]] * 3)
    _, ids = jax.lax.top_k(jnp.full((3, 8), 0.125), 2)
    np.testing.assert_array_equal(np.asarray(ids), [[0, 1]] * 3)
