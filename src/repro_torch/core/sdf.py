"""Implicit SDF evaluation (paper §1: ICARUS "also supports implicit signed
distance function (SDF) evaluation, potentially useful for geometry
extraction and isosurface polygonisation"), in PyTorch.

The SDF network is a coordinate MLP over isotropic-RFF-encoded positions
(Fig. 4(a), middle pattern). Besides raw evaluation, the two downstream
consumers the paper names: sphere tracing (ray -> surface hit) and a
dense-grid evaluator feeding isosurface extraction. With a
``mlp.pack_quant`` quant tree every RMCM layer runs through K3 on the card
(``mlp.mlp_apply``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.encoding import PEU
from repro_torch.core.mlp import mlp_apply, mlp_decls


def sdf_decls(peu: PEU, widths=(256, 256, 256, 256)) -> dict:
    return mlp_decls(peu.out_dim, list(widths), 1)


def sdf_eval(peu: PEU, params, pts, quant: Optional[dict] = None):
    """pts (..., 3) -> signed distance (...,)."""
    return mlp_apply(params, peu(pts), quant=quant)[..., 0]


def sdf_normal(peu: PEU, params, pts, eps: float = 1e-4,
               quant: Optional[dict] = None):
    """Finite-difference surface normals (the hardware-friendly
    estimator): pts (..., 3) -> unit normals (..., 3)."""
    offs = torch.eye(3, dtype=pts.dtype, device=pts.device) * eps
    d_plus = torch.stack([sdf_eval(peu, params, pts + offs[i], quant)
                          for i in range(3)], dim=-1)
    d_minus = torch.stack([sdf_eval(peu, params, pts - offs[i], quant)
                           for i in range(3)], dim=-1)
    g = (d_plus - d_minus) / (2 * eps)
    return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                           min=1e-9)


def sphere_trace(peu: PEU, params, rays_o, rays_d, *, n_steps: int = 64,
                 t_min: float = 0.0, t_max: float = 10.0,
                 hit_eps: float = 1e-3, quant: Optional[dict] = None):
    """Fixed-step sphere tracing, exactly ``n_steps`` steps (the
    reference's ``scan``): a done ray keeps its ``t``; a ray is done once
    |d| < ``hit_eps`` or it reaches ``t_max``. Returns (t, hit_mask)."""
    t = torch.full(rays_o.shape[:-1], t_min, dtype=rays_o.dtype,
                   device=rays_o.device)
    done = torch.zeros_like(t, dtype=torch.bool)
    for _ in range(n_steps):
        d = sdf_eval(peu, params, rays_o + t[..., None] * rays_d, quant)
        t_new = torch.where(done, t, torch.clamp(t + d.abs(), max=t_max))
        done = done | (d.abs() < hit_eps) | (t_new >= t_max)
        t = t_new
    return t, done & (t < t_max)


def eval_grid(peu: PEU, params, resolution: int, lo: float = -1.0,
              hi: float = 1.0, chunk: int = 65536,
              quant: Optional[dict] = None):
    """Dense SDF grid for isosurface extraction: the points of
    ``linspace(lo, hi, resolution)`` cubed in ``meshgrid(indexing="ij")``
    order, evaluated ``chunk`` points at a time on the params' device.
    Returns (res, res, res)."""
    xs = torch.linspace(lo, hi, resolution,
                        device=params["l0"]["w"].device)
    grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), dim=-1)
    flat = grid.reshape(-1, 3)
    outs = [sdf_eval(peu, params, flat[i:i + chunk], quant)
            for i in range(0, flat.shape[0], chunk)]
    return torch.cat(outs).reshape(resolution, resolution, resolution)


def sphere_sdf(pts, radius: float = 0.5, center=(0.0, 0.0, 0.0)):
    """Analytic reference SDF for tests and examples."""
    c = torch.as_tensor(center, dtype=pts.dtype, device=pts.device)
    return torch.linalg.norm(pts - c, dim=-1) - radius
