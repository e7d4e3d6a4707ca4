"""Wrapper of the RMCM dequant-fused matmul CUDA kernel
(``csrc/rmcm_matmul.cu``), K3.

``rmcm_matmul(x, packed)`` computes ``y = x @ W`` for one (M, K) ``x``
(float32 or bfloat16) and a (K, N) weight kept in the 9-bit RMCM storage
format of ``core.rmcm.pack``: uint8 magnitudes, signs bit-packed along K,
one float32 scale per output column. The sum is float32, the scale is
applied once after the whole K sum, and ``y`` comes back in ``x.dtype``.

A CUDA tensor launches the kernel on the current stream (``y`` allocated
here with ``torch.empty``); a CPU tensor takes the plain version,
``kernels.ref.rmcm_matmul_ref``. Nothing else: no fallback from one to the
other. ``LAUNCHES`` counts kernel launches and is touched nowhere but at a
launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

LAUNCHES = {"rmcm_matmul": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def _check_operands(x: torch.Tensor, packed: dict):
    """Shapes, types and devices of one call; returns (M, K, N)."""
    mag, sgn, scale = packed["mag"], packed["sign_bits"], packed["scale"]
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got shape {tuple(x.shape)}")
    M, K = x.shape
    if mag.ndim != 2 or mag.shape[0] != K or packed["k"] != K:
        raise ValueError(f"x has K={K} but the weight has mag "
                         f"{tuple(mag.shape)} and k={packed['k']}")
    N = mag.shape[1]
    if tuple(sgn.shape) != (-(-K // 8), N):
        raise ValueError(f"sign_bits has shape {tuple(sgn.shape)}, expected "
                         f"{(-(-K // 8), N)}")
    if scale.numel() != N:
        raise ValueError(f"scale has {scale.numel()} entries, expected {N}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes float32 "
                        "or bfloat16")
    for name, t, dt in (("mag", mag, torch.uint8), ("sign_bits", sgn,
                                                     torch.uint8),
                        ("scale", scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dt}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return M, K, N


def rmcm_matmul(x: torch.Tensor, packed: dict, *, bm: int = 128,
                bn: int = 128, bk: int = 256) -> torch.Tensor:
    """x (M, K) float32 or bfloat16; ``packed`` the ``rmcm.pack`` of a
    (K, N) weight. Returns (M, N) in ``x.dtype``. ``bm``/``bn``/``bk`` are
    the reference's TPU block sizes, taken for signature parity: the
    kernel picks its own tiles and masks the ragged edges, and the result
    does not depend on them."""
    M, K, N = _check_operands(x, packed)
    if x.device.type == "cpu":
        return ref.rmcm_matmul_ref(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"no RMCM matmul kernel for device {x.device}")
    from repro_torch.kernels import build
    x = x.contiguous()
    mag = packed["mag"].contiguous()
    sgn = packed["sign_bits"].contiguous()
    scale = packed["scale"].contiguous()
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.load().rmcm_matmul(
        x.data_ptr(), mag.data_ptr(), sgn.data_ptr(), scale.data_ptr(),
        y.data_ptr(), M, K, N, int(x.dtype == torch.bfloat16),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rmcm_matmul failed to launch: CUDA error {rc}")
    LAUNCHES["rmcm_matmul"] += 1
    return y
