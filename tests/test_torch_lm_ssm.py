"""LM serving in the port, SSM (mamba2) and hybrid (recurrentgemma)
families, against the reference on the same weights: per arch ``loss``,
prefill, state cache and teacher-forced decode, the reference's
prefill/decode consistency, the chunked SSD with and without a trailing
partial chunk (S = 17 and 32 at chunk 16), the RG-LRU associative scan,
and the hybrid's ring cache decoding past its window (prompt 40, window
32). Tolerances in ``tests/_torch_lm_common.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru

from repro_torch.models import rglru

from _torch_lm_common import (check_arch, check_bf16_op_by_op,
                              check_consistency, close, models,
                              one_torch_thread)  # noqa: F401

ARCHS = ["mamba2-2.7b", "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_reference(arch):
    check_arch(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    check_consistency(arch)


def test_bf16_smoke_matches_reference_op_by_op():
    check_bf16_op_by_op("recurrentgemma-9b", steps=1)


@pytest.mark.parametrize("S", [17, 32])
def test_ssd_chunks_match_reference(S):
    """``_ssd`` at chunk 16: S = 17 takes one full chunk and the
    trailing partial one, S = 32 two full chunks; y and the final state."""
    jm, jp, m, p = models("mamba2-2.7b")
    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, S, m.cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    lp = {k: v[0] for k, v in p["layers"].items() if not isinstance(v, dict)}
    jz, jx, jB, jC, jdt = jm._branches(jlp, jnp.asarray(h))
    H0 = np.zeros((2, m.nh, m.cfg.ssm.head_dim, m.cfg.ssm.d_state), np.float32)
    jy, jH = jm._ssd(jlp, jx, jB, jC, jdt, jnp.asarray(H0))
    _, xr, Br, Cr, dt, _ = m._branches(lp, torch.from_numpy(h))
    close(jx, xr, 1e-6)
    y, H = m._ssd(lp, xr, Br, Cr, dt, torch.from_numpy(H0))
    close(jy, y, 1e-5)
    close(jH, H, 1e-5)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_lru_scan_matches_reference(S):
    """The associative scan at even, odd and unit lengths, with and
    without an initial state."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 8)).astype(np.float32)
    b = rng.standard_normal((2, S, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    for init in (None, h0):
        want = jrglru._lru_scan(jnp.asarray(a), jnp.asarray(b),
                                None if init is None else jnp.asarray(init))
        got = rglru._lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                              None if init is None else torch.from_numpy(init))
        close(want, got, 1e-6)


def test_ring_cache_decodes_past_window():
    """recurrentgemma's local attention over its window-sized ring: a
    40-token prompt against a 32-slot window, then decode steps."""
    check_arch("recurrentgemma-9b", S=40, steps=4)
