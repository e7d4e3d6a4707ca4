"""VRU — volume rendering unit (paper §4.4), log-space parallel form.

T_i = exp(sum_{j<i} x_j) with x_i = -max(sigma_i, 0) * delta_i, and
C = sum_i T_i (1 - exp(x_i)) c_i.
"""
from __future__ import annotations

import torch


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    # shift-based, never ``cumsum - x``: with a far-capped last delta
    # x_last ~ -1e10 the subtraction cancels the whole prefix sum
    c = torch.cumsum(x, dim=-1)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def render_parallel(sigma, rgb, deltas):
    """sigma: (..., N); rgb: (..., N, 3); deltas: (..., N) ->
    (rgb (..., 3), {weights, transmittance, acc})."""
    x = -torch.clamp(sigma, min=0.0) * deltas
    T = torch.exp(_exclusive_cumsum(x))
    w = T * (1.0 - torch.exp(x))
    out = torch.sum(w[..., None] * rgb, dim=-2)
    return out, {"weights": w, "transmittance": T, "acc": torch.sum(w, dim=-1)}


def composite_depth(weights, t_vals):
    """Expected ray depth from volume-rendering weights."""
    return torch.sum(weights * t_vals, dim=-1)


def white_background(rgb, acc):
    """Composite onto white (synthetic NeRF scenes convention)."""
    return rgb + (1.0 - acc[..., None])
