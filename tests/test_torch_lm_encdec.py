"""LM serving in the port, encoder-decoder family (whisper), against the
reference on the same weights: ``loss``, prefill (encoder over the frames,
self and cross caches), teacher-forced decode with the learned decoder
positions, the reference's prefill/decode consistency, the bf16 smoke
config, and the clamped slice of the decoder positions past
``MAX_DEC_POS``. Tolerances in ``tests/_torch_lm_common.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import encdec as jencdec

from repro_torch.models import encdec

from _torch_lm_common import (batch, check_arch, check_bf16_op_by_op,
                              check_consistency, close, models,
                              one_torch_thread, split)  # noqa: F401

ARCH = "whisper-large-v3"


def test_matches_reference():
    check_arch(ARCH)


def test_prefill_decode_consistency():
    check_consistency(ARCH)


def test_bf16_smoke_matches_reference_op_by_op():
    check_bf16_op_by_op(ARCH)


def test_encoder_matches_reference():
    jm, jp, m, p = models(ARCH)
    b = batch(m.cfg, 2, 5)
    jb, tb = split(b, 5)
    close(jax.jit(jm.encode)(jp, jb["frames"]), m.encode(p, tb["frames"]), 1e-5)


def test_decoder_position_past_table_clamps_like_reference():
    """``dynamic_slice_in_dim`` clamps a start past the table; decode at
    pos MAX_DEC_POS + 3 reads the last row in both packages."""
    assert encdec.MAX_DEC_POS == jencdec.MAX_DEC_POS
    jm, jp, m, p = models(ARCH)
    S = 6
    b = batch(m.cfg, 2, S + 1)
    jpre, tpre = split(b, S)
    cap = encdec.MAX_DEC_POS + 8
    jc, _ = jax.jit(lambda q, x: jm.prefill(q, x, cap))(jp, jpre)
    tc, _ = m.prefill(p, tpre, cap)
    pos = encdec.MAX_DEC_POS + 3
    tok = b["tokens"][:, S:S + 1]
    _, jlog = jax.jit(jm.decode)(jp, jc, jnp.asarray(tok),
                                 jnp.asarray(pos, jnp.int32))
    _, tlog = m.decode(p, tc, torch.from_numpy(tok), pos)
    close(jlog, tlog, 2e-3)
    np.testing.assert_array_equal(
        encdec._dec_pos(p, pos, 1, "float32").numpy(),
        np.asarray(jp["dec_pos"][-1:]))
