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
SLF network. ``lm_params_from_numpy`` carries an LM's parameter tree (the
reference's ``init_params`` layout, stacked layer axes and all),
``lm_opt_state_from_numpy`` its AdamW state.

bfloat16 crosses as its 16-bit pattern: numpy has no bf16, and
``np.asarray`` of a JAX bf16 array is an ``ml_dtypes`` array (dtype name
``bfloat16``), which a checkpoint stores as 2-byte voids (``|V2``). Both
become ``torch.bfloat16`` tensors; a bf16 tensor comes back as ``|V2``
voids holding the same bits. ``ml_dtypes`` is not imported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoding import PEU


def is_bf16_array(a: np.ndarray) -> bool:
    """An ``ml_dtypes`` bfloat16 array, or 2-byte voids (a bf16 leaf as
    ``np.load`` returns it)."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2)


def array_to_tensor(a) -> torch.Tensor:
    """A host copy of ``a`` as a tensor; bf16 patterns become bfloat16."""
    a = np.array(a, copy=True, order="C")
    if is_bf16_array(a):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; a bfloat16 tensor as ``|V2`` voids."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view("V2")
    return t.numpy()


def to_torch(tree, device=None):
    """Nested dict of array-likes -> nested dict of tensors (same keys)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if tree is None or isinstance(tree, (int, float)):
        return tree
    t = array_to_tensor(tree)
    return t if device is None else t.to(device)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (same keys)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tensor_to_array(tree)
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


def lm_params_from_numpy(tree, device=None):
    """An LM's parameter tree as the reference's ``init_params`` gives it
    (nested dicts of numpy arrays, layer stacks on the leading axis, as
    ``np.asarray`` of each leaf) -> the port's tree of tensors on
    ``device``: the same keys, shapes, dtypes and bits. The port's models
    read this layout as it is."""
    return to_torch(tree, device)


def lm_opt_state_from_numpy(tree, device=None):
    """The reference's AdamW state of an LM (``opt_state_decls`` as
    ``init_params`` gives it, or as a train step returns it, each leaf as
    ``np.asarray``) -> the port's: ``m`` and ``v`` shaped like the params
    (f32 leaves, or ``{"q": int8, "scale": f32}`` with int8 moments), the
    int32 ``step`` scalar, and with the compressed step the f32 ``err``
    residuals; the same keys, dtypes and bits, so that both states take
    the same step."""
    return to_torch(tree, device)


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
