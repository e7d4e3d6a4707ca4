"""Ray sampling — the paper's two-pass strategy (§5.1).

``stratified`` places the coarse samples (bin midpoints in inference mode,
jittered with a ``torch.Generator`` in training mode); ``importance``
resamples the fine set by inverse CDF over the coarse weights. The
deterministic forms ``importance_det`` and ``merge_sorted_ranks`` are the
ones the fused two-pass kernel computes per ray (a binary search and a
merge of two sorted lists); here they are written with ``searchsorted``,
which gives the same values as the reference's comparison counts.

Both grids are ``_linspace0``, which reproduces the reference's float32
grid bit for bit (``torch.linspace`` rounds some points differently).
"""
from __future__ import annotations

from typing import Optional

import torch


def _linspace0(stop: float, n: int, device=None) -> torch.Tensor:
    """``n`` evenly spaced float32 points from 0 to ``stop``, rounded as
    the reference's compiled ``jnp.linspace(0.0, stop, n)`` rounds them:
    its compiler turns ``stop * (i / (n - 1))`` into
    ``i * (stop * f32(1 / (n - 1)))``, each product rounded to float32,
    and the last point is ``stop`` itself."""
    f32 = torch.float32
    if n < 2:
        return torch.zeros(n, dtype=f32, device=device)
    one = torch.ones((), dtype=f32, device=device)
    step = torch.tensor(stop, dtype=f32, device=device) * (one / (n - 1))
    i = torch.arange(n - 1, dtype=f32, device=device)
    return torch.cat([i * step, torch.tensor([stop], dtype=f32,
                                             device=device)])


def stratified(near: float, far: float, n: int, shape=(),
               generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """Jittered-uniform samples (bin midpoints without a generator).
    Returns t: (*shape, n), sorted ascending."""
    edges = _linspace0(1.0, n + 1, device)
    lo, hi = edges[:-1], edges[1:]
    if generator is not None:
        u = torch.rand(tuple(shape) + (n,), generator=generator,
                       device=device)
    else:
        u = 0.5
    s = torch.broadcast_to(lo + (hi - lo) * u, tuple(shape) + (n,))
    return near + (far - near) * s


def det_u(n: int, device=None) -> torch.Tensor:
    """The deterministic (inference-mode) u-grid, shared by the host sampler
    and the fused kernel's in-block resampler."""
    return _linspace0(1.0 - 1e-6, n, device)


def _weights_to_cdf(weights, eps: float = 1e-5):
    """Coarse weights (..., M) -> CDF over the M-1 interior bins (..., M-1);
    the edge weights are dropped, as NeRF does."""
    w = weights[..., 1:-1] + eps
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


def _invert_cdf(t_mid, cdf, u):
    # searchsorted(side="right") is the count of CDF entries <= u
    M1 = cdf.shape[-1]
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u.contiguous(),
                                         right=True) - 1, 0, M1 - 2)
    cdf_lo = torch.gather(cdf, -1, idx)
    cdf_hi = torch.gather(cdf, -1, idx + 1)
    t_lo = torch.gather(t_mid[..., :-1], -1, idx)
    t_hi = torch.gather(t_mid[..., 1:], -1, idx)
    denom = torch.where(cdf_hi - cdf_lo < 1e-8, torch.ones_like(cdf_lo),
                        cdf_hi - cdf_lo)
    frac = (u - cdf_lo) / denom
    return t_lo + frac * (t_hi - t_lo)


def importance(t_mid, weights, n: int,
               generator: Optional[torch.Generator] = None,
               eps: float = 1e-5):
    """Inverse-CDF sampling from the piecewise-constant pdf over the gaps
    between the coarse positions ``t_mid`` (..., M). Returns (..., n)."""
    cdf = _weights_to_cdf(weights, eps)
    shape = cdf.shape[:-1] + (n,)
    if generator is not None:
        u = torch.rand(shape, generator=generator, device=cdf.device)
    else:
        u = torch.broadcast_to(det_u(n, cdf.device), shape)
    return _invert_cdf(t_mid, cdf, u)


def importance_det(t_mid, weights, n: int, eps: float = 1e-5,
                   u_row: Optional[torch.Tensor] = None):
    """The deterministic inverse CDF the fused kernel runs: the u-grid is
    ``det_u`` (or a prebuilt ``u_row`` of it, (n,)) and the bin is found by
    binary search (the count of CDF entries <= u), clipped to [0, M-3].
    Equal to ``importance`` without a generator, value for value."""
    cdf = _weights_to_cdf(weights, eps)
    if u_row is None:
        u_row = det_u(n, cdf.device)
    u = torch.broadcast_to(u_row, cdf.shape[:-1] + (n,))
    return _invert_cdf(t_mid, cdf, u)


def merge_sorted(t_a, t_b):
    """Union of two sample sets along a ray, sorted (coarse + fine pass)."""
    return torch.sort(torch.cat([t_a, t_b], dim=-1), dim=-1).values


def merge_sorted_ranks(t_a, t_b):
    """Merge of two already-sorted sets: each element lands at its own index
    plus the count of the OTHER set's elements before it, ties going to
    ``t_a`` (the coarse sample). Same values as ``merge_sorted``."""
    na, nb = t_a.shape[-1], t_b.shape[-1]
    t_a, t_b = t_a.contiguous(), t_b.contiguous()
    ia = torch.arange(na, device=t_a.device)
    ib = torch.arange(nb, device=t_b.device)
    rank_a = ia + torch.searchsorted(t_b, t_a, right=False)   # b <  a
    rank_b = ib + torch.searchsorted(t_a, t_b, right=True)    # a <= b
    out = torch.empty(t_a.shape[:-1] + (na + nb,), dtype=t_a.dtype,
                      device=t_a.device)
    out.scatter_(-1, rank_a, t_a)
    out.scatter_(-1, rank_b, t_b)
    return out


def deltas_from_t(t, far_cap: float = 1e10):
    """delta_i = t_{i+1} - t_i, the last one capped (paper eq. (4) note)."""
    d = t[..., 1:] - t[..., :-1]
    return torch.cat([d, torch.full_like(t[..., :1], far_cap)], dim=-1)
