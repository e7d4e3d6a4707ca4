"""Parameter declarations and their initialization.

A model declares its parameters once as a nested dict of ``Decl`` (shape +
initializer); ``init_params`` turns that tree into tensors drawn from an
explicit ``torch.Generator``. The draws cannot match the reference's
``jax.random`` stream, so parity tests load the reference's weights through
``repro_torch.bridge`` instead of initializing on both sides.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Decl:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones | embed | small
    scale: float = 1.0                   # fan-in style scale applied to "normal"
    dtype: Optional[str] = None          # override param_dtype


def _init_one(d: Decl, gen: torch.Generator, param_dtype: str):
    dt = getattr(torch, d.dtype or param_dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=gen.device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=gen.device)
    z = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    if d.init == "small":
        return (0.01 * z).to(dt)
    # fan-in scaled normal, the reference's rule; "embed" uses
    # 1/sqrt(d_model) so tied-embedding logits are O(1) at init
    if d.init == "embed":
        std = d.shape[-1] ** -0.5
    else:
        fan_in = d.shape[0] if len(d.shape) == 1 else int(np.prod(d.shape[:-1])) / (
            d.shape[0] if len(d.shape) > 2 else 1)
        std = d.scale / np.sqrt(max(int(fan_in), 1))
    return (std * z).to(dt)


def init_params(decls, gen: torch.Generator, param_dtype: str = "float32"):
    """Decl tree -> tensor tree on the generator's device. Leaves are drawn
    in sorted-key order, so one generator state always gives the same
    tree."""
    if isinstance(decls, Decl):
        return _init_one(decls, gen, param_dtype)
    return {k: init_params(decls[k], gen, param_dtype) for k in sorted(decls)}


def param_bytes(decls, param_dtype: str = "float32") -> int:
    if isinstance(decls, Decl):
        itemsize = torch.empty((), dtype=getattr(torch, decls.dtype or param_dtype)
                               ).element_size()
        return int(np.prod(decls.shape)) * itemsize
    return sum(param_bytes(v, param_dtype) for v in decls.values())


def param_count(decls) -> int:
    if isinstance(decls, Decl):
        return int(np.prod(decls.shape))
    return sum(param_count(v) for v in decls.values())
