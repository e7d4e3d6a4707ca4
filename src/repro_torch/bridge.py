"""Weight bridge: nested dicts of numpy arrays <-> nested dicts of tensors.

The reference package keeps its ``params`` and ``quant`` trees as nested
dicts of arrays (``quant`` leaves are ``{"mag", "sign", "scale"}`` dicts, or
plain arrays for vectors). Handed over as numpy arrays, they become the
port's tensors under the same key paths, with the same dtypes (float32,
uint8 magnitudes, bool signs), bit for bit. Only numpy crosses: this module
imports neither the reference package nor its framework.

``mlp_from_numpy`` and ``peu_from_numpy`` carry a generic coordinate MLP
(its params, its RMCM quant tree, packed for K3 on request) and a PEU's
frequency matrix across, so that both packages evaluate the same SDF or
SLF network.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoding import PEU


def to_torch(tree, device=None):
    """Nested dict of array-likes -> nested dict of tensors (same keys)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if tree is None or isinstance(tree, (int, float)):
        return tree
    t = torch.from_numpy(np.array(tree, copy=True, order="C"))
    return t if device is None else t.to(device)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (same keys)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def resolve_device(device, who: str) -> torch.device:
    """The device of an entry point: ``cuda`` unless the caller names
    another; raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on the card by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain versions")
    return dev


def to_device(tree, device):
    """Move every tensor of a nested dict to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def mlp_from_numpy(params, quant=None, device=None, pack: bool = False):
    """A generic MLP's ``params`` and optional RMCM ``quant`` tree (nested
    dicts of numpy arrays, the reference's ``quantize_tree`` layout) ->
    ``(params, quant)`` as tensors on ``device``; ``pack`` packs the quant
    tree for the K3 route (``core.mlp.pack_quant``)."""
    from repro_torch.core.mlp import pack_quant
    p = to_torch(params, device)
    q = None if quant is None else to_torch(quant, device)
    if q is not None and pack:
        q = pack_quant(q)
    return p, q


def peu_from_numpy(mode: str, in_dim: int, A, *, include_input: bool = True,
                   device=None) -> PEU:
    """A random-feature PEU (``rff_iso`` or ``rff_aniso``) on a frequency
    matrix ``A`` (in_dim, F) handed over as data, e.g. the reference's
    ``PEU.A``: its keyed draw cannot be repeated by a ``torch.Generator``."""
    A = np.asarray(A, np.float32)
    return PEU(mode, in_dim, n_features=A.shape[1], A=A,
               include_input=include_input, device=device)
