"""LM serving in the port, dense and VLM families, against the reference on
the same weights: the configs and their parameter declarations, then per
arch ``loss``, prefill logits and cache, teacher-forced decode, the
reference's prefill/decode consistency, the bf16 smoke config, the
clamped cache write, and the bf16-vs-f32 gap. Tolerances in
``tests/_torch_lm_common.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import params as jax_params
from repro.models.model_zoo import build_model as jax_build

from repro_torch import configs
from repro_torch.models import layers, params
from repro_torch.models.model_zoo import build_model

from _torch_lm_common import (batch, check_arch, check_bf16_op_by_op,
                              check_consistency, close, models,
                              one_torch_thread, split)  # noqa: F401

DENSE = ["qwen2-1.5b", "qwen2.5-14b", "qwen3-32b", "minitron-8b",
         "paligemma-3b"]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.init, tree.dtype)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_configs_match_reference(arch):
    """The port's copies: every field of the full and the smoke config,
    the parameter count, and each Decl's shape, init and dtype."""
    assert configs.list_archs() == jax_configs.list_archs()
    for get in ("get_config", "smoke_config"):
        ours = getattr(configs, get)(arch)
        ref = getattr(jax_configs, get)(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_count() == ref.param_count()
        assert ours.param_count(active_only=True) == \
            ref.param_count(active_only=True)
    cfg = configs.smoke_config(arch)
    decls = build_model(cfg).param_decls()
    ref = jax_build(jax_configs.smoke_config(arch)).param_decls()
    assert _shapes(decls) == jax.tree.map(
        lambda d: (d.shape, d.init, d.dtype), ref,
        is_leaf=jax_params.is_decl)
    assert params.param_bytes(decls) == jax_params.param_bytes(ref)
    assert params.param_count(decls) == jax_params.param_count(ref)


def test_embed_init_std():
    """The "embed" initializer draws at std d_model ** -0.5."""
    w = params.init_params({"e": params.Decl((4096, 64), (None, None),
                                                init="embed")},
                           torch.Generator().manual_seed(0))["e"]
    assert abs(float(w.std()) - 64 ** -0.5) < 2e-3


@pytest.mark.parametrize("arch", DENSE)
def test_matches_reference(arch):
    check_arch(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    check_consistency(arch)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "paligemma-3b"])
def test_bf16_smoke_matches_reference_op_by_op(arch):
    check_bf16_op_by_op(arch)


def test_decode_past_capacity_clamps_like_reference():
    """Without a capacity the cache is prompt-sized; the reference's
    ``dynamic_update_slice`` clamps the first decode write to the last
    slot, and so does the port (torch would raise)."""
    jm, jp, m, p = models("qwen2-1.5b")
    S = 9
    b = batch(m.cfg, 2, S + 1)
    jpre, tpre = split(b, S)
    jc, _ = jax.jit(jm.prefill)(jp, jpre)
    tc, _ = m.prefill(p, tpre)
    assert tc["k"].shape[2] == S
    tok = b["tokens"][:, S:S + 1]
    jc, jlog = jax.jit(jm.decode)(jp, jc, jnp.asarray(tok),
                                  jnp.asarray(S, jnp.int32))
    tc, tlog = m.decode(p, tc, torch.from_numpy(tok), S)
    close(jlog, tlog, 2e-3)
    np.testing.assert_array_equal(
        np.asarray(jc["k"].astype(jnp.float32)), tc["k"].float().numpy())


def test_attention_masks_and_softcap_match_reference():
    """``attention`` over several chunks with a padded last chunk, each
    mask kind, a prefix and a window, softcap and invalid slots."""
    from repro.models import layers as jl
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 21, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 21, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 21, 2, 8)).astype(np.float32)
    valid = rng.random(21) > 0.2
    valid[0] = True
    pos = np.arange(21, dtype=np.int32)
    for kind, extra in (("causal", {}), ("local", {"window": 5}),
                        ("prefix", {"prefix_len": 6}), ("full", {})):
        kw = dict(kind=kind, chunk=8, softcap=3.0, **extra)
        want = jl.attention(*map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(pos),
                            kv_valid=jnp.asarray(valid), **kw)
        got = layers.attention(*map(torch.from_numpy, (q, k, v)),
                               q_pos=torch.from_numpy(pos),
                               kv_valid=torch.from_numpy(valid), **kw)
        close(want, got, 1e-5)


def test_bf16_gap_within_twice_reference():
    """The port's bf16-vs-f32 gap of prefill logits (qwen2 smoke config,
    same weights) is at most twice the reference's jitted gap: the gate
    ``chip_smoke.py`` applies on the card at full width."""
    jm, jp, m, p = models("qwen2-1.5b")
    b = batch(m.cfg, 2, 17)
    jpre, tpre = split(b, 17)
    ref, ours = {}, {}
    for dt in ("bfloat16", "float32"):
        jm = jax_build(jax_configs.smoke_config("qwen2-1.5b").replace(dtype=dt))
        ref[dt] = np.asarray(jax.jit(jm.prefill)(jp, jpre)[1], np.float32)
        mm = build_model(m.cfg.replace(dtype=dt))
        ours[dt] = mm.prefill(mm.serving_params(p), tpre)[1].float().numpy()
    ref_gap = np.abs(ref["bfloat16"] - ref["float32"]).max()
    our_gap = np.abs(ours["bfloat16"] - ours["float32"]).max()
    assert 0 < our_gap <= 2 * ref_gap, (our_gap, ref_gap)
