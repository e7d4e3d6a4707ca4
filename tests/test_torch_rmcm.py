"""RMCM in the PyTorch port: bit-identical to the reference package.

On the same f32 weights (made with numpy from a fixed seed) magnitudes,
signs, scales and packed sign bits equal the reference's exactly, and the
approximation keeps its 1/9 worst-case relative error.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rmcm as jr

from repro_torch.core import rmcm


def _weights(shape, seed):
    w = np.random.default_rng(seed).normal(0, 0.3, shape).astype(np.float32)
    w[..., 0, :] = np.round(w[..., 0, :] * 8) / 8   # ties and exact values
    w[..., -1] = 0.0                                 # an all-zero column
    return w


@pytest.mark.parametrize("shape", [(24, 16), (63, 64), (3, 40, 8)])
def test_quantize_bit_identical(shape):
    w = _weights(shape, sum(shape))
    ref = jr.quantize(jnp.asarray(w))
    got = rmcm.quantize(torch.from_numpy(w))
    for k in ("mag", "sign", "scale"):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert r.dtype == g.dtype and r.shape == g.shape, k
        np.testing.assert_array_equal(r, g, err_msg=k)


def test_pack_bits_identical_and_round_trip():
    w = _weights((61, 12), 7)                       # K not a multiple of 8
    q = rmcm.quantize(torch.from_numpy(w))
    ref = jr.pack(jr.quantize(jnp.asarray(w)))
    p = rmcm.pack(q)
    np.testing.assert_array_equal(np.asarray(ref["sign_bits"]),
                                  p["sign_bits"].numpy())
    back = rmcm.unpack(p)
    assert torch.equal(back["sign"], q["sign"])
    assert torch.equal(rmcm.dequantize(back), rmcm.dequantize(q))


def test_max_relative_error_is_one_ninth():
    m = torch.arange(1, 256)
    approx = rmcm.approx_magnitude(m)
    err = ((approx - m).abs().to(torch.float64) / m).max().item()
    assert err == pytest.approx(1 / 9, abs=1e-12)
    assert rmcm.max_relative_error() == jr.max_relative_error()
    nib = torch.cat([approx >> 4, approx & 0xF]).unique().tolist()
    assert set(nib) <= rmcm.REPRESENTABLE


def test_dequantize_and_matmul_match_reference():
    w = _weights((40, 24), 3)
    x = np.random.default_rng(4).normal(size=(5, 40)).astype(np.float32)
    ref_q = jr.quantize(jnp.asarray(w))
    q = rmcm.quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jr.dequantize(ref_q)),
                                  rmcm.dequantize(q).numpy())
    np.testing.assert_allclose(
        np.asarray(jr.rmcm_matmul_ref(jnp.asarray(x), ref_q)),
        rmcm.rmcm_matmul_ref(torch.from_numpy(x), q).numpy(),
        rtol=1e-5, atol=1e-5)


def test_quantize_tree_quantizes_matrices_only():
    tree = {"a": {"w": torch.ones(4, 3), "b": torch.zeros(3)}}
    q = rmcm.quantize_tree(tree)
    assert set(q["a"]["w"]) == {"mag", "sign", "scale"}
    assert torch.equal(q["a"]["b"], tree["a"]["b"])
