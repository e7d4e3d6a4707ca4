"""VRU — volume rendering unit (paper §4.4).

Three algebraically equivalent forms of Max's volume rendering integral,
with x_i = -max(sigma_i, 0) * delta_i:

* ``render_ref``      — paper eq. (4): T_i = exp(sum_{j<i} x_j),
  C = sum_i T_i (1 - exp(x_i)) c_i. The oracle.
* ``render_scan``     — paper eq. (5), the VRU's streaming recurrence:
  T_{i+1} = T_i * exp(x_i), C += (T_i - T_{i+1}) c_i, samples consumed in
  order (a Python loop over the sample axis, O(1) state per ray).
* ``render_parallel`` — the log-space cumulative-sum form (one exp per
  sample, vectorized), the training-time form.

All return (rgb, aux) with aux = {weights, transmittance, acc}. The
exclusive prefix is shifted, never ``cumsum - x``: with the far-capped
last delta (1e10) the subtraction would cancel the whole prefix sum.
"""
from __future__ import annotations

import torch


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    # shift-based, never ``cumsum - x``: with a far-capped last delta
    # x_last ~ -1e10 the subtraction cancels the whole prefix sum
    c = torch.cumsum(x, dim=-1)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def _x_terms(sigma, deltas):
    """x_i = -sigma_i * delta_i (paper notation), sigma >= 0 enforced."""
    return -torch.clamp(sigma, min=0.0) * deltas


def _aux(w, T) -> dict:
    return {"weights": w, "transmittance": T, "acc": torch.sum(w, dim=-1)}


def render_ref(sigma, rgb, deltas):
    """Paper eq. (4), direct. sigma: (..., N); rgb: (..., N, 3); deltas:
    (..., N) -> (rgb (..., 3), aux)."""
    x = _x_terms(sigma, deltas)
    T = torch.exp(_exclusive_cumsum(x))
    w = T * (1.0 - torch.exp(x))
    return torch.sum(w[..., None] * rgb, dim=-2), _aux(w, T)


def render_scan(sigma, rgb, deltas):
    """Paper eq. (5), the VRU's streaming recurrence (Fig. 10): per sample
    T_{i+1} = T_i * exp(x_i) and the contribution (T_i - T_{i+1}) c_i."""
    x = _x_terms(sigma, deltas)
    T = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    out = torch.zeros(x.shape[:-1] + (3,), dtype=x.dtype, device=x.device)
    ws, Ts = [], []
    for i in range(x.shape[-1]):
        T_next = T * torch.exp(x[..., i])
        w = T - T_next
        out = out + w[..., None] * rgb[..., i, :]
        ws.append(w)
        Ts.append(T)
        T = T_next
    return out, _aux(torch.stack(ws, dim=-1), torch.stack(Ts, dim=-1))


def render_parallel(sigma, rgb, deltas):
    """The log-space parallel form: eq. (4)'s math as one cumulative sum
    and one exp per sample. sigma: (..., N); rgb: (..., N, 3); deltas:
    (..., N) -> (rgb (..., 3), {weights, transmittance, acc})."""
    x = _x_terms(sigma, deltas)
    T = torch.exp(_exclusive_cumsum(x))
    w = T * (1.0 - torch.exp(x))
    out = torch.sum(w[..., None] * rgb, dim=-2)
    return out, _aux(w, T)


def composite_depth(weights, t_vals):
    """Expected ray depth from volume-rendering weights."""
    return torch.sum(weights * t_vals, dim=-1)


def white_background(rgb, acc):
    """Composite onto white (synthetic NeRF scenes convention)."""
    return rgb + (1.0 - acc[..., None])
