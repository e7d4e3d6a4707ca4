"""PEU — positional encoding unit (paper §4.2).

Three frequency-matrix modes behind one API, the paper's "universal PEU":
``nerf_fixed`` (octave-spaced fixed frequencies), ``rff_iso`` (isotropic
random Fourier features, A ~ N(0, sigma^2 I), phi(x) = [cos(A^T x),
sin(A^T x)]) and ``rff_aniso`` (per-axis sigmas); ``make_frequency_matrix``,
``fourier_features`` and the ``PEU`` class.

The NeRF encoding: gamma(x) = [x, sin(2^0 x), cos(2^0 x), ...,
sin(2^{L-1} x), cos(2^{L-1} x)], frequency-major: all D channels of octave k are contiguous, sines first.
``nerf_encoding_double_angle`` computes the same layout with the PEU's
double-angle recurrence (one sin/cos pair, then 2 muls + 1 add per octave),
which is what both the fused kernels and their plain versions compute.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
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


# -------------------------------------------------------- frequency matrix --
def make_frequency_matrix(mode: str, in_dim: int, n_features: int,
                          generator: Optional[torch.Generator] = None,
                          sigma: float = 10.0, sigmas=None,
                          device=None) -> torch.Tensor:
    """A (in_dim, n_features), the paper's Fig. 4(a) frequency patterns:
    ``nerf_fixed`` octave-spaced axis-aligned frequencies (n_features =
    in_dim * L), ``rff_iso`` sigma * N(0, 1), ``rff_aniso`` per-axis sigmas
    * N(0, 1). The random modes draw from ``generator`` (a
    ``torch.Generator``; they cannot give ``jax.random``'s numbers: a
    matrix the reference drew crosses as data, ``PEU(A=...)``)."""
    if mode == "nerf_fixed":
        L = n_features // in_dim
        A = torch.zeros((in_dim, in_dim * L), dtype=torch.float32,
                        device=device)
        for k in range(L):
            for a in range(in_dim):
                A[a, k * in_dim + a] = 2.0 ** k
        return A
    if mode in ("rff_iso", "rff_aniso"):
        if generator is None:
            raise ValueError(f"{mode} draws its matrix: pass a generator")
        z = torch.randn((in_dim, n_features), generator=generator,
                        device=generator.device)
        if device is not None:
            z = z.to(device)
        if mode == "rff_iso":
            return sigma * z
        if sigmas is None:
            raise ValueError("rff_aniso needs per-axis sigmas")
        s = torch.as_tensor(sigmas, dtype=torch.float32,
                            device=z.device).reshape(in_dim, 1)
        return s * z
    raise ValueError(f"unknown encoding mode {mode!r}")


def fourier_features(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """phi(x; A) = [cos(A^T x), sin(A^T x)] (paper eq. (1)).
    x: (..., in_dim); A: (in_dim, F) -> (..., 2F)."""
    z = x @ A
    return torch.cat([torch.cos(z), torch.sin(z)], dim=-1)


# ------------------------------------------------------------ universal PEU -
class PEU:
    """The universal positional-encoding unit: configured once (mode and
    frequency matrix), applied to streamed coordinates. ``nerf_fixed``
    encodes with direct sin/cos or, with ``double_angle``, the PEU's
    recurrence; the random modes apply ``fourier_features`` with the
    matrix ``A`` if given (e.g. the reference's, crossed as data), else
    one drawn from ``generator``."""

    def __init__(self, mode: str, in_dim: int, *, n_freqs: int = 0,
                 n_features: int = 0,
                 generator: Optional[torch.Generator] = None,
                 sigma: float = 10.0, sigmas=None,
                 include_input: bool = True, double_angle: bool = False,
                 A: Optional[torch.Tensor] = None, device=None):
        self.mode = mode
        self.in_dim = in_dim
        self.n_freqs = n_freqs
        self.include_input = include_input
        self.double_angle = double_angle
        extra = in_dim if include_input else 0
        if mode == "nerf_fixed":
            if n_freqs <= 0:
                raise ValueError("nerf_fixed needs n_freqs > 0")
            self.A = make_frequency_matrix(mode, in_dim, in_dim * n_freqs,
                                           device=device)
            self.out_dim = in_dim * 2 * n_freqs + extra
        else:
            if n_features <= 0:
                raise ValueError(f"{mode} needs n_features > 0")
            self.A = (torch.tensor(np.asarray(A), dtype=torch.float32,
                                   device=device)
                      if A is not None else make_frequency_matrix(
                          mode, in_dim, n_features, generator, sigma,
                          sigmas, device))
            if tuple(self.A.shape) != (in_dim, n_features):
                raise ValueError(f"A has shape {tuple(self.A.shape)}, "
                                 f"expected {(in_dim, n_features)}")
            self.out_dim = 2 * n_features + extra

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "nerf_fixed":
            fn = (nerf_encoding_double_angle if self.double_angle
                  else nerf_encoding)
            return fn(x, self.n_freqs, self.include_input)
        enc = fourier_features(x, self.A.to(x.dtype))
        return torch.cat([x, enc], dim=-1) if self.include_input else enc


# ------------------------------------------- Mip-NeRF: integrated encoding --
# Mip-NeRF (arXiv:2103.13415, ``internal/mip.py``) casts a cone per pixel:
# the interval [t0, t1] of a ray is a conical frustum, which it stands in
# for by a Gaussian (its mean and diagonal covariance) and encodes by the
# expected value of the sines and cosines over that Gaussian. The forms
# here are mip-NeRF's stable ones, each operation rounded on its own, in
# the order the fused kernel computes them.

def frustum_rows(t0: torch.Tensor, t1: torch.Tensor):
    """The along-ray moments of the conical frustums [t0, t1]: (t_mean,
    t_var, r_var / r^2), with mu and hw the interval's middle and half
    width. They depend on the edges alone, so a row of edges shared by
    every ray gives one row of moments."""
    mu = (t0 + t1) * 0.5
    hw = (t1 - t0) * 0.5
    mu2, hw2 = mu * mu, hw * hw
    den = 3.0 * mu2 + hw2
    hw4 = hw2 * hw2
    t_mean = mu + (2.0 * mu * hw2) / den
    t_var = hw2 / 3.0 - (4.0 / 15.0) * ((hw4 * (12.0 * mu2 - hw2))
                                        / (den * den))
    r_unit = mu2 / 4.0 + (5.0 / 12.0) * hw2 - (4.0 / 15.0) * hw4 / den
    return t_mean, t_var, r_unit


def lift_gaussian(o, d, r, t_mean, t_var, r_unit):
    """Each frustum's Gaussian in space: mean o + d t_mean and the diagonal
    covariance t_var d^2 + r^2 r_unit (1 - d^2 / |d|^2), for rays o, d
    (..., 3) and cone radii r (...,) over moments (..., N). Returns (mean,
    cov), each (..., N, 3)."""
    d2 = d * d
    mag = torch.clamp((d2[..., 0] + d2[..., 1]) + d2[..., 2], min=1e-10)
    null = 1.0 - d2 / mag[..., None]                        # (..., 3)
    r_var = (r * r)[..., None] * r_unit                     # (..., N)
    mean = o[..., None, :] + d[..., None, :] * t_mean[..., None]
    cov = (t_var[..., None] * d2[..., None, :]
           + r_var[..., None] * null[..., None, :])
    return mean, cov


def integrated_pos_enc(mean, cov, min_deg: int, max_deg: int):
    """The IPE of Gaussians (..., 3) x 2: for each degree l of [min_deg,
    max_deg) and axis a, sin(2^l x_a) exp(-4^l var_a / 2), then the same
    cosines: all sines of every degree first, as mip-NeRF orders them. The
    cosine is cos(y), the exact value of mip-NeRF's sin(y + pi / 2)."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=mean.dtype,
                                 device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    y = (mean[..., None, :] * scales[:, None]).reshape(shape)
    v = (cov[..., None, :] * (scales * scales)[:, None]).reshape(shape)
    w = torch.exp(-0.5 * v)
    return torch.cat([w * torch.sin(y), w * torch.cos(y)], dim=-1)


def mip_dir_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """Mip-NeRF's view-direction encoding: [x, sin(2^l x) for every degree
    and axis, then the cosines] (degree-major, axes within a degree)."""
    scales = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(xb), torch.cos(xb)], dim=-1)
