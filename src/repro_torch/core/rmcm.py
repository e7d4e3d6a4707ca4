"""RMCM — the paper's 9-bit weight scheme (§4.3, Fig. 7), in PyTorch.

Each weight is 1 sign bit + an 8-bit magnitude whose two nibbles are snapped
to values the shift-add array can form: {o << s : o in {1,3,5,7}} + {0},
so 9, 11, 13, 15 round down (the approximated RMCM of Fig. 7(b)). Scaling
is per output column, absmax/255.

Numerics contract (same as the reference, held by tests):
* every approximated nibble is representable;
* the max relative error of the approximated magnitude is exactly 1/9
  (at 0x99 = 153 -> 0x88 = 136);
* quantize -> pack -> unpack -> dequantize round-trips bit-exactly, and
  mag/sign/scale equal the reference's on the same f32 weights.
"""
from __future__ import annotations

import numpy as np
import torch

# nibble -> nearest RMCM-representable value; 9, 11, 13, 15 snap down
_NIBBLE_TABLE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 8, 10, 10, 12, 12, 14, 14], np.int32)

REPRESENTABLE = frozenset(
    {0} | {o << s for o in (1, 3, 5, 7) for s in range(4) if (o << s) < 16})


def approx_magnitude(m: torch.Tensor) -> torch.Tensor:
    """Per-nibble RMCM approximation of 8-bit magnitudes (int tensor)."""
    m = m.to(torch.int64)
    table = torch.as_tensor(_NIBBLE_TABLE, dtype=torch.int64, device=m.device)
    return (table[(m >> 4) & 0xF] << 4) | table[m & 0xF]


def quantize(w: torch.Tensor, axis: int = -2) -> dict:
    """Float weights -> {mag: uint8, sign: bool, scale: f32}; ``axis`` is the
    contraction dim, so scale has shape (..., 1, N) for (..., K, N)."""
    amax = torch.amax(w.abs(), dim=axis, keepdim=True)
    # a true division, as the reference's: on a CUDA tensor PyTorch divides
    # by a Python scalar as a product with its reciprocal, which rounds
    # most scales differently, moves magnitudes that sit on a rounding
    # tie, and changes what QAT trains on the card
    scale = torch.clamp(amax / torch.full_like(amax, 255.0), min=1e-20)
    # torch.round rounds half to even, as the reference does
    m_exact = torch.clamp(torch.round(w.abs() / scale), 0, 255).to(torch.int64)
    mag = approx_magnitude(m_exact).to(torch.uint8)
    return {"mag": mag, "sign": w < 0, "scale": scale.to(torch.float32)}


def dequantize(q: dict, dtype=torch.float32) -> torch.Tensor:
    m = q["mag"].to(torch.float32)
    s = torch.where(q["sign"], -1.0, 1.0)
    return (s * m * q["scale"]).to(dtype)


def fake_quant(w: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """w -> dequantize(quantize(w)) on the forward pass, with the identity
    as its gradient (the straight-through estimator of quantization-aware
    training). Written as the reference writes it, ``w + (dq - w)``, so
    the forward values equal the reference's bit for bit."""
    w0 = w.detach()
    return w + (dequantize(quantize(w0, axis), w.dtype) - w0)


def pack(q: dict) -> dict:
    """Bit-pack signs 8 per byte along the leading axis: bit j of byte i is
    row 8i + j (1.125 bytes per weight)."""
    sign = q["sign"]
    K = sign.shape[0]
    pad = (-K) % 8
    sp = torch.cat([sign, sign.new_zeros((pad,) + sign.shape[1:])]) if pad \
        else sign
    return {"mag": q["mag"], "sign_bits": pack_signs(sp),
            "scale": q["scale"], "k": K}


def unpack(p: dict) -> dict:
    bits = p["sign_bits"]
    sign = unpack_signs(bits, bits.shape[0] * 8)[:p["k"]].to(torch.bool)
    return {"mag": p["mag"], "sign": sign, "scale": p["scale"]}


def pack_signs(sign: torch.Tensor) -> torch.Tensor:
    """(K, ...) bool -> (K/8, ...) uint8, K % 8 == 0."""
    K = sign.shape[0]
    if K % 8:
        raise ValueError(f"sign rows {K} are not a multiple of 8")
    sp = sign.reshape(K // 8, 8, *sign.shape[1:]).to(torch.int64)
    shifts = torch.arange(8, device=sign.device).reshape(
        1, 8, *([1] * (sign.ndim - 1)))
    return (sp << shifts).sum(dim=1).to(torch.uint8)


def unpack_signs(bits: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows/8, N) uint8 -> (rows, N) {0,1} uint8. Bit j of byte i = row 8i+j."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device).reshape(1, 8, 1)
    return ((bits[:, None, :] >> shifts) & 1).reshape(rows, bits.shape[-1])


def rmcm_matmul_ref(x: torch.Tensor, q: dict) -> torch.Tensor:
    """Reference y = x @ dequantize(q). x: (..., K); q over (K, N)."""
    return x @ dequantize(q, torch.float32)


def quantize_tree(params, axis: int = -2):
    """RMCM-quantize every float matrix (ndim >= 2) of a param tree; vectors
    (biases) stay exact, as the paper runs the MCM on matrices only."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, axis) for k, v in params.items()}
    if params.ndim >= 2 and params.is_floating_point():
        return quantize(params, axis)
    return params


def fake_quant_tree(params, axis: int = -2):
    """``fake_quant`` on every float matrix (ndim >= 2) of a param tree;
    vectors (biases) pass through."""
    if isinstance(params, dict):
        return {k: fake_quant_tree(v, axis) for k, v in params.items()}
    if params.ndim >= 2 and params.is_floating_point():
        return fake_quant(params, axis)
    return params


def max_relative_error() -> float:
    """Analytic worst case of approx_magnitude over all 8-bit magnitudes."""
    m = np.arange(1, 256)
    approx = (_NIBBLE_TABLE[(m >> 4) & 0xF] << 4) | _NIBBLE_TABLE[m & 0xF]
    return float(np.max(np.abs(approx - m) / m))
