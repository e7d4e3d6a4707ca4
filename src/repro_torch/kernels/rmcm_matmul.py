"""Wrapper of the RMCM dequant-fused matmul CUDA kernel
(``csrc/rmcm_matmul.cu``), K3.

``rmcm_matmul(x, packed)`` computes ``y = x @ W`` for one (M, K) ``x``
(float32 or bfloat16) and a (K, N) weight kept in the 9-bit RMCM storage
format of ``core.rmcm.pack``: uint8 magnitudes, signs bit-packed along K,
one float32 scale per output column. The sum is float32, the scale is
applied once after the whole K sum, and ``y`` comes back in ``x.dtype``.

The kernel runs on Hopper's warpgroup MMA (bf16x3 for an f32 ``x``, one
bf16 product for a bf16 ``x``, both exact against the signed
magnitudes), the packed weight tiles staged by the TMA, in persistent
128x128 tiles. Its plan names one of two routes by M, ``large_m`` and,
for M <= ``SMALL_M``, ``small_m`` (the decode shapes, where K is split).
Where the tiles cannot fill the card, K is split across blocks into a
scratch buffer allocated here, and a second launch adds the splits in a
fixed order and applies the scale. The result depends on the route only
through the order of the sum, and two calls give the same bits.

A CUDA tensor launches the kernel on the current stream (``y`` and the
scratch allocated here with ``torch.empty``); a CPU tensor takes the plain
version, ``kernels.ref.rmcm_matmul_ref``. Nothing else: no fallback from
one to the other. ``LAUNCHES`` counts kernel launches (one per call, both
routes), ``ROUTE_LAUNCHES`` the same launches by route and
``SHAPE_LAUNCHES`` by shape ("MxKxN"); all are touched nowhere but at a
launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref

LAUNCHES = {"rmcm_matmul": 0}
ROUTE_LAUNCHES = {"large_m": 0, "small_m": 0}
SHAPE_LAUNCHES: dict = {}
SMALL_M = 64     # the largest M of the small route (csrc/rmcm_matmul.cu)

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


def route(M: int) -> str:
    return "small_m" if M <= SMALL_M else "large_m"


@functools.lru_cache(maxsize=None)
def _plan(M: int, K: int, N: int, bf16: bool, device: torch.device):
    """The kernel's plan for one shape on one card: (route, K splits,
    chunks per split, blocks), as a ctypes int[4]."""
    from repro_torch.kernels import build
    plan = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = build.load().rmcm_matmul_plan(M, K, N, int(bf16),
                                           ctypes.cast(plan, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"rmcm_matmul_plan failed: CUDA error {rc}")
    return plan


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
    bf16 = x.dtype == torch.bfloat16
    plan = _plan(M, K, N, bf16, x.device)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part = (torch.empty((plan[1], M, N), dtype=torch.float32,
                        device=x.device) if plan[1] > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.load().rmcm_matmul(
        x.data_ptr(), mag.data_ptr(), sgn.data_ptr(), scale.data_ptr(),
        y.data_ptr(), None if part is None else part.data_ptr(), M, K, N,
        int(bf16), ctypes.cast(plan, ctypes.c_void_p),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rmcm_matmul failed to launch: CUDA error {rc}")
    LAUNCHES["rmcm_matmul"] += 1
    ROUTE_LAUNCHES[route(M)] += 1
    shape = f"{M}x{K}x{N}"
    SHAPE_LAUNCHES[shape] = SHAPE_LAUNCHES.get(shape, 0) + 1
    return y
