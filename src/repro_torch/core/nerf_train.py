"""NeRF training on the PLCore pipeline, with RMCM quantization-aware
training (``qat=True``: the forward pass reads the straight-through
fake-quantized matrices, so the networks learn around the 1/9
approximation error).

Loss = MSE(coarse) + MSE(fine), both heads supervised (original NeRF).
The render is ``plcore.render_rays``'s plain route; gradients come from
``torch.autograd.grad`` over the leaves of the parameter dict, and the
step applies ``optim.adam.adam_update``. A ``torch.Generator`` (on the
rays' device) jitters the samples; without one the route is the
deterministic one (bin midpoints, the ``det_u`` resample grid).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.bridge import resolve_device, to_device
from repro_torch.configs.nerf_icarus import NerfConfig
from repro_torch.core import rmcm
from repro_torch.core.plcore import plcore_decls, render_rays
from repro_torch.models.params import init_params
from repro_torch.optim.adam import (AdamConfig, adam_update, opt_state_decls,
                                    tree_leaves, tree_unflatten)


def psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def make_nerf_loss(cfg: NerfConfig, *, qat: bool = False,
                   white_bkgd: bool = True) -> Callable:
    """loss_fn(params, batch, generator=None) -> (loss, {mse, psnr})."""
    def loss_fn(params, batch, generator: Optional[torch.Generator] = None):
        # fake-quant only matrices; fake_quant_tree skips the biases
        p = rmcm.fake_quant_tree(params) if qat else params
        out = render_rays(cfg, p, batch["rays_o"], batch["rays_d"], generator,
                          white_bkgd=white_bkgd)
        mse_f = torch.mean(torch.square(out["rgb"] - batch["rgb"]))
        mse_c = torch.mean(torch.square(out["rgb_coarse"] - batch["rgb"]))
        return mse_f + mse_c, {"mse": mse_f, "psnr": psnr(mse_f)}
    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """loss_fn(params, *args) -> (loss, aux) becomes a function returning
    ((loss, aux), grads), grads a dict shaped like params; the loss and
    aux come back detached."""
    def wrapped(params, *args):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves)
        return ((loss.detach(), {k: v.detach() for k, v in aux.items()}),
                tree_unflatten(params, grads))
    return wrapped


def make_nerf_train_step(cfg: NerfConfig, opt_cfg: AdamConfig, *,
                         qat: bool = False) -> Callable:
    """train_step(params, opt_state, batch, generator=None) ->
    (params, opt_state, {mse, psnr, grad_norm, lr, loss})."""
    grad_fn = value_and_grad(make_nerf_loss(cfg, qat=qat))

    def train_step(params, opt_state, batch,
                   generator: Optional[torch.Generator] = None):
        (loss, metrics), grads = grad_fn(params, batch, generator)
        params, opt_state, om = adam_update(opt_cfg, params, grads,
                                            opt_state)
        return params, opt_state, {**metrics, **om, "loss": loss}

    return train_step


def init_nerf_state(cfg: NerfConfig, opt_cfg: AdamConfig,
                    generator: torch.Generator, device=None):
    """(params, opt_state) for both networks: params drawn from
    ``generator``, zero moments and step, all on ``device`` (default the
    card)."""
    dev = resolve_device(device, "init_nerf_state")
    decls = plcore_decls(cfg)
    params = init_params(decls, generator, cfg.dtype)
    opt_state = init_params(opt_state_decls(decls, opt_cfg), generator,
                            "float32")
    return to_device(params, dev), to_device(opt_state, dev)
