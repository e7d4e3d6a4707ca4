"""RMCM quantization-aware training wrappers (paper §4.3: the 1/9
approximation error "can be further compensated during the training
process").

Wrap a loss so the selected weight matrices pass through the
straight-through RMCM fake-quantizer on the forward pass; export with
``quantize_for_deploy``. Params are nested dicts of tensors; a leaf's path
is the tuple of its keys, and the filter reads it ``/``-joined.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import rmcm


def default_filter(path, leaf: torch.Tensor) -> bool:
    """Quantize weight matrices (ndim >= 2), skip embeddings and norms:
    the MONB/SONB split, hidden matmuls approximate, heads/tables exact."""
    name = "/".join(str(p) for p in path)
    if leaf.ndim < 2:
        return False
    if any(k in name for k in ("embed", "unembed", "norm", "pos")):
        return False
    return True


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def fake_quant_selected(params, should_quant: Callable = default_filter):
    """Straight-through fake-quant on the leaves selected by the filter."""
    def one(path, leaf):
        if leaf.is_floating_point() and should_quant(path, leaf):
            return rmcm.fake_quant(leaf)
        return leaf
    return _map_with_path(one, params)


def qat_loss(loss_fn: Callable, should_quant: Callable = default_filter):
    """loss_fn(params, ...) -> loss_fn with RMCM fake-quant in the forward.
    Gradients flow straight through to the master weights."""
    def wrapped(params, *args, **kw):
        return loss_fn(fake_quant_selected(params, should_quant), *args, **kw)
    return wrapped


def quantize_for_deploy(params, should_quant: Callable = default_filter):
    """Post-QAT export: RMCM-quantize the selected leaves (others pass
    through). The result pairs with ``kernels.ops.rmcm_matmul``."""
    def one(path, leaf):
        if leaf.is_floating_point() and should_quant(path, leaf):
            return rmcm.quantize(leaf)
        return leaf
    return _map_with_path(one, params)
