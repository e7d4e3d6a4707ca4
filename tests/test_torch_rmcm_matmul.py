"""The port's RMCM dequant-fused matmul (K3) against the reference.

The same packed weights go through the bridge; the port's ``ops.rmcm_matmul``
on CPU tensors (its plain version) is held against the reference's Pallas
kernel in interpret mode and against the reference's plain
``rmcm_matmul_ref``, at the reference test's shapes and tolerances: f32
atol 2e-4 / rtol 1e-4; bf16 atol 0.3 / rtol 0.05 (bf16 output rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rmcm as jr
from repro.kernels import ops as jops
from repro.kernels.ref import rmcm_matmul_ref as jax_ref

from repro_torch import bridge
from repro_torch.core import rmcm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmcm_matmul as k3

F32_TOL = dict(atol=2e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.3, rtol=0.05)


def _weights(k, n, seed):
    """(reference packed, port packed) of one seeded (k, n) weight."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    jp = jr.pack(jr.quantize(jnp.asarray(w)))
    tp = bridge.to_torch({key: np.asarray(v) for key, v in jp.items()
                          if key != "k"})
    tp["k"] = jp["k"]
    return jp, tp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both_refs(x, jp, **kw):
    xj = jnp.asarray(x)
    return (np.asarray(jops.rmcm_matmul(xj, jp, interpret=True, **kw),
                       np.float32),
            np.asarray(jax_ref(xj, jp), np.float32))


def test_packed_format_crosses_the_bridge_unchanged():
    jp, tp = _weights(300, 96, 0)
    ours = rmcm.pack(rmcm.quantize(torch.from_numpy(
        np.random.default_rng(0).standard_normal((300, 96)).astype(
            np.float32))))
    for key in ("mag", "sign_bits", "scale"):
        np.testing.assert_array_equal(np.asarray(jp[key]), tp[key].numpy())
        assert torch.equal(ours[key], tp[key])
    assert ours["k"] == tp["k"] == 300


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (7, 13, 5), (128, 256, 128),
                                   (64, 300, 96), (33, 512, 65)])
def test_rmcm_matmul_shapes_match_reference(m, k, n):
    jp, tp = _weights(k, n, 0)
    x = _x((m, k), 1)
    y = ops.rmcm_matmul(torch.from_numpy(x), tp)
    assert y.shape == (m, n) and y.dtype == torch.float32
    for want in _both_refs(x, jp):
        np.testing.assert_allclose(y.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmcm_matmul_dtypes_match_reference(dtype):
    jp, tp = _weights(64, 32, 2)
    x32 = _x((16, 64), 3)
    xj = jnp.asarray(x32).astype(dtype)
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    # both sides see the same bf16 inputs
    np.testing.assert_array_equal(np.asarray(xj, np.float32),
                                  xt.float().numpy())
    y = ops.rmcm_matmul(xt, tp)
    assert y.dtype == xt.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want in (jops.rmcm_matmul(xj, jp, interpret=True), jax_ref(xj, jp)):
        assert want.dtype == xj.dtype
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_rmcm_matmul_batched_leading_dims():
    jp, tp = _weights(24, 16, 4)
    x = _x((2, 5, 24), 5)
    y = ops.rmcm_matmul(torch.from_numpy(x), tp)
    assert y.shape == (2, 5, 16)
    for want in _both_refs(x, jp):
        np.testing.assert_allclose(y.numpy(), want, atol=2e-4)


@pytest.mark.parametrize("bm,bn,bk", [(8, 8, 8), (16, 48, 32),
                                      (128, 128, 256)])
def test_rmcm_matmul_block_sweep(bm, bn, bk):
    """The result does not depend on the reference's block sizes."""
    jp, tp = _weights(96, 48, 6)
    x = _x((40, 96), 7)
    y = ops.rmcm_matmul(torch.from_numpy(x), tp, bm=bm, bn=bn, bk=bk)
    assert torch.equal(y, ops.rmcm_matmul(torch.from_numpy(x), tp))
    for want in _both_refs(x, jp, bm=bm, bn=bn, bk=bk):
        np.testing.assert_allclose(y.numpy(), want, **F32_TOL)


def test_plain_version_scales_after_the_sum():
    """The plain version is the kernel's order: product with the signed
    magnitudes in f32, then the per-column scale, then the cast."""
    _, tp = _weights(40, 12, 8)
    x = torch.from_numpy(_x((9, 40), 9))
    sg = rmcm.unpack_signs(tp["sign_bits"], tp["sign_bits"].shape[0] * 8)
    w = tp["mag"].float() * (1.0 - 2.0 * sg[:40].float())
    assert torch.equal(ref.rmcm_matmul_ref(x, tp),
                       (x @ w) * tp["scale"].reshape(1, -1))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, tp = _weights(16, 8, 10)
    with pytest.raises(ValueError, match="K="):
        k3.rmcm_matmul(torch.zeros(3, 17), tp)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k3.rmcm_matmul(torch.zeros(3, 16, dtype=torch.float64), tp)
    with pytest.raises(ValueError, match="M, K"):
        k3.rmcm_matmul(torch.zeros(2, 3, 16), tp)
    # the CPU path takes the plain version and launches nothing
    n0 = k3.LAUNCHES["rmcm_matmul"]
    k3.rmcm_matmul(torch.zeros(3, 16), tp)
    assert k3.LAUNCHES["rmcm_matmul"] == n0
