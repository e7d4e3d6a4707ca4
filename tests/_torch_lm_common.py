"""Shared helpers of the LM parity tests (``tests/test_torch_lm*.py``):
the reference's and the port's model of an arch on the reference's
weights (``init_params`` with ``PRNGKey(0)``, carried across by
``bridge.lm_params_from_numpy``), numpy-seeded batches, and the parity
check of one arch.

Tolerances (f32 smoke configs): ``loss`` at rtol 1e-5, prefill logits of
the last position at 1e-4, the prefill cache within one bf16 ulp (f32
state leaves at 1e-5), teacher-forced decode logits at 2e-3; gradients
(``grad_gap``) within 1e-4 of the whole gradient's largest |g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model_zoo import build_model as jax_build
from repro.models.params import init_params as jax_init

from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.models.model_zoo import build_model

LOSS_RTOL, PREFILL_TOL, DECODE_TOL = 1e-5, 1e-4, 2e-3
CONSISTENCY_TOL = 2e-2      # tests/test_models.py's prefill/decode check


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the test
    workers that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(arch: str, **over):
    """(reference model, its params, port model, port params) of an arch's
    smoke config with ``over`` replaced on both sides."""
    jcfg = jax_smoke_config(arch).replace(**over)
    cfg = smoke_config(arch).replace(**over)
    jm, m = jax_build(jcfg), build_model(cfg)
    jp = jax_init(jm.param_decls(), jax.random.PRNGKey(0), jcfg.param_dtype)
    p = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, m, p


def batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    """numpy inputs: tokens (B, S) and labels (the next token), the VLM's
    patches and the enc-dec frames (0.1 * normal)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.family == "vlm":
        out["patches"] = (0.1 * rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (0.1 * rng.standard_normal(
            (B, cfg.encdec.enc_seq, cfg.d_model))).astype(np.float32)
    return out


def split(b: dict, S: int):
    """(reference, port) prefill batches of the first S tokens."""
    pre = {k: (v[:, :S] if k == "tokens" else v) for k, v in b.items()
           if k != "labels"}
    return ({k: jnp.asarray(v) for k, v in pre.items()},
            {k: torch.from_numpy(v) for k, v in pre.items()})


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), rtol=tol, atol=tol)


def within_bf16_ulp(a, b):
    """Every element of two bf16 caches equal or one bf16 ulp apart."""
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.float().numpy()
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(a - b) <= ulp).all(), float(np.abs(a - b).max())


def check_cache(jc: dict, tc: dict):
    assert sorted(jc) == sorted(tc)
    for k in jc:
        assert tuple(jc[k].shape) == tuple(tc[k].shape), k
        if tc[k].dtype == torch.bfloat16:
            assert jc[k].dtype == jnp.bfloat16, k
            within_bf16_ulp(jc[k], tc[k])
        else:
            np.testing.assert_allclose(np.asarray(jc[k]), tc[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def check_arch(arch: str, B: int = 2, S: int = 17, steps: int = 4, **over):
    """loss, prefill logits and cache, then ``steps`` teacher-forced
    decode steps, the port against the reference on the same weights."""
    jm, jp, m, p = models(arch, **over)
    b = batch(m.cfg, B, S + steps)
    full = {k: (v[:, :S] if k in ("tokens", "labels") else v)
            for k, v in b.items()}
    jl = jax.jit(jm.loss)(jp, {k: jnp.asarray(v) for k, v in full.items()})
    tl = m.loss(p, {k: torch.from_numpy(v) for k, v in full.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)

    jpre, tpre = split(b, S)
    cap = S + steps + 1 + jm.prefix_len()
    jc, jlog = jax.jit(lambda q, x: jm.prefill(q, x, cap))(jp, jpre)
    tc, tlog = m.prefill(p, tpre, cap)
    close(jlog, tlog, PREFILL_TOL)
    check_cache(jc, tc)

    dec = jax.jit(jm.decode)
    for i in range(steps):
        tok = b["tokens"][:, S + i:S + i + 1]
        jc, jlog = dec(jp, jc, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        tc, tlog = m.decode(p, tc, torch.from_numpy(tok), S + i)
        close(jlog, tlog, DECODE_TOL)


def check_consistency(arch: str, B: int = 2, S: int = 17):
    """tests/test_models.py's check on the port: decode(prefill(x), x_last)
    logits == prefill(x + x_last) logits."""
    _, _, m, p = models(arch)
    b = batch(m.cfg, B, S)
    _, short = split(b, S - 1)
    _, whole = split(b, S)
    cache, _ = m.prefill(p, short, S + m.prefix_len())
    _, dec = m.decode(p, cache, whole["tokens"][:, -1:], S - 1)
    _, ref = m.prefill(p, whole)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(),
                               rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)


def check_bf16_op_by_op(arch: str, B: int = 2, S: int = 17, steps: int = 2):
    """The arch's smoke config in bfloat16: prefill and decode logits of
    the port (weights cast once, ``serving_params``) against the reference
    run op by op (``jax.disable_jit``) at 2e-2. Jitted, XLA fuses the
    reference's bf16 chains and keeps some intermediates in f32; op by op
    it rounds every result as torch does. Against the jitted reference
    the port's prefill logits are at most twice as far as the reference
    op by op is from itself jitted."""
    jm, jp, m, p = models(arch, dtype="bfloat16")
    b = batch(m.cfg, B, S + steps)
    jpre, tpre = split(b, S)
    cap = S + steps + 1 + jm.prefix_len()
    sp = m.serving_params(p)
    _, jit_log = jax.jit(lambda q, x: jm.prefill(q, x, cap))(jp, jpre)
    with jax.disable_jit():
        jc, jlog = jm.prefill(jp, jpre, cap)
        tc, tlog = m.prefill(sp, tpre, cap)
        assert tlog.dtype == torch.bfloat16
        close(jlog, tlog, CONSISTENCY_TOL)
        # against the jitted reference the port is as far as the
        # reference is from itself run op by op
        dist = lambda a: float(np.abs(np.asarray(jit_log, np.float32)
                                      - np.asarray(a, np.float32)).max())
        assert dist(tlog.float().numpy()) <= 2 * dist(jlog) + 1e-6
        for i in range(steps):
            tok = b["tokens"][:, S + i:S + i + 1]
            jc, jlog = jm.decode(jp, jc, jnp.asarray(tok),
                                 jnp.asarray(S + i, jnp.int32))
            tc, tlog = m.decode(sp, tc, torch.from_numpy(tok), S + i)
            close(jlog, tlog, CONSISTENCY_TOL)


GRAD_TOL = 1e-4             # of the whole gradient's largest |g|


def leaves_with_path(tree, path=()):
    """[("a/b", leaf)] of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_path(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def as_np(x) -> np.ndarray:
    """A reference array or a port tensor as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def grad_gap(ref, port):
    """(worst leaf, its largest |ref - port| over the whole reference
    gradient's largest |g|) of two gradient trees."""
    ref, port = dict(leaves_with_path(ref)), dict(leaves_with_path(port))
    assert sorted(ref) == sorted(port)
    gmax = max(float(np.abs(as_np(g)).max()) for g in ref.values())
    gaps = {k: float(np.abs(as_np(ref[k]) - as_np(port[k])).max()) / gmax
            for k in ref}
    worst = max(gaps, key=gaps.get)
    return worst, gaps[worst]


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}
