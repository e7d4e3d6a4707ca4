"""Surface light field rendering (paper §5.1, Fig. 13), in PyTorch.

"An SLF is a collection of all light rays and their radiances that emit
from the surface of an object in all directions ... compactly encoded in a
fully-connected neural network."

The SLF network maps (surface point, view direction) -> RGB directly: the
same PEU + MLP engine as NeRF but no VRU (one surface sample per ray), in
the anisotropic-RFF PEU mode. With a ``mlp.pack_quant`` quant tree every
RMCM layer runs through K3 on the card (``mlp.mlp_apply``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.encoding import PEU
from repro_torch.core.mlp import mlp_apply, mlp_decls


def make_slf_peu(generator: Optional[torch.Generator] = None,
                 n_features: int = 128, sigma_pos: float = 8.0,
                 sigma_dir: float = 1.0, *, A=None, device=None) -> PEU:
    """Anisotropic RFF over the 6-D (point, direction) input, Fig. 4(a)
    right: position axes encoded at a higher frequency than direction
    axes (the PEU's R^6 mode, two 3x128 memory banks, §4.2). The matrix
    is drawn from ``generator``, or taken as data (``A``, e.g. the
    reference's, whose ``jax.random`` draw a generator cannot give)."""
    sigmas = np.array([sigma_pos] * 3 + [sigma_dir] * 3, np.float32)
    return PEU("rff_aniso", 6, n_features=n_features, generator=generator,
               sigmas=sigmas, A=A, device=device)


def slf_decls(peu: PEU, widths=(256, 256, 128)) -> dict:
    return mlp_decls(peu.out_dim, list(widths), 3)


def slf_eval(peu: PEU, params, points, dirs, quant: Optional[dict] = None):
    """(points (..., 3), dirs (..., 3)) -> rgb (..., 3) in [0, 1]."""
    x = torch.cat([points, dirs], dim=-1)
    return mlp_apply(params, peu(x), quant=quant,
                     final_activation=torch.sigmoid)


def slf_loss(peu: PEU, params, batch, quant: Optional[dict] = None):
    pred = slf_eval(peu, params, batch["points"], batch["dirs"], quant=quant)
    return torch.mean(torch.square(pred - batch["rgb"]))
