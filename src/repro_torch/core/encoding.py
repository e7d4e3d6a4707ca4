"""PEU — positional encoding unit (paper §4.2), the fixed NeRF mode.

gamma(x) = [x, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)],
frequency-major: all D channels of octave k are contiguous, sines first.
``nerf_encoding_double_angle`` computes the same layout with the PEU's
double-angle recurrence (one sin/cos pair, then 2 muls + 1 add per octave),
which is what both the fused kernels and their plain versions compute.
"""
from __future__ import annotations

import torch


def nerf_encoding(x: torch.Tensor, n_freqs: int,
                  include_input: bool = True) -> torch.Tensor:
    """x: (..., D) -> (..., D*2*n_freqs [+ D]) with direct sin/cos."""
    scales = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * scales[:, None]                       # (..., L, D)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)      # (..., L, 2D)
    enc = enc.reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], dim=-1) if include_input else enc


def nerf_encoding_double_angle(x: torch.Tensor, n_freqs: int,
                               include_input: bool = True) -> torch.Tensor:
    """Same layout as ``nerf_encoding`` via sin(2a) = 2 sin a cos a,
    cos(2a) = 1 - 2 sin^2 a."""
    s, c = torch.sin(x), torch.cos(x)
    feats = [x] if include_input else []
    for _ in range(n_freqs):
        feats += [s, c]
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    return torch.cat(feats, dim=-1)
