"""Step builders shared by train.py and serve.py.

``make_train_step`` wires loss -> grad -> (optional gradient transform) ->
AdamW; ``make_grad_accum_train_step`` sums microbatch gradients before one
update; ``make_dp_compressed_train_step`` mean-reduces the gradients over a
process group with the int8-compressed all-gather and error feedback of
``runtime.compression``. ``make_prefill_step`` / ``make_decode_step`` wrap
the model's serving entry points. All are functions of explicit state.

Gradients come from ``torch.autograd.grad`` over the leaves of the
parameter dict (sorted-key order, the reference's tree order). Stochastic
rounding of bf16 params draws from a ``torch.Generator`` seeded by (17,
step), where the reference folds the step into ``PRNGKey(17)``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.optim.adam import (AdamConfig, adam_update, tree_leaves,
                                    tree_unflatten)
from repro_torch.runtime.compression import (group_size, init_error_state,
                                             tree_compressed_psum_mean)


def loss_and_grads(loss_fn: Callable, params, batch):
    """(detached loss, gradient tree shaped like ``params``); a leaf the
    loss does not read gets a zero gradient, as ``jax.grad`` gives it."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _sround_generator(opt_cfg: AdamConfig, step: torch.Tensor):
    """The stochastic-rounding draw of this step, or None without it."""
    if not opt_cfg.stochastic_round:
        return None
    return torch.Generator(step.device).manual_seed(17 << 32 | int(step))


def make_train_step(model, opt_cfg: AdamConfig, *,
                    grad_compression: Optional[Callable] = None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model.loss, params, batch)
        if grad_compression is not None:
            grads = grad_compression(grads)
        params, opt_state, metrics = adam_update(
            opt_cfg, params, grads, opt_state,
            generator=_sround_generator(opt_cfg, opt_state["step"]))
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_grad_accum_train_step(model, opt_cfg: AdamConfig, n_micro: int):
    """Gradient accumulation: the batch's leading axis split into
    ``n_micro`` microbatches, their f32 gradients summed and divided once,
    a single deferred optimizer update."""

    def train_step(params, opt_state, batch):
        split = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
                 for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        losses = []
        for i in range(n_micro):
            loss, grads = loss_and_grads(
                model.loss, params, {k: v[i] for k, v in split.items()})
            acc = [a + g.to(torch.float32)
                   for a, g in zip(acc, tree_leaves(grads))]
            losses.append(loss)
        grads = tree_unflatten(params, [a / n_micro for a in acc])
        params, opt_state, metrics = adam_update(
            opt_cfg, params, grads, opt_state,
            generator=_sround_generator(opt_cfg, opt_state["step"]))
        metrics["loss"] = torch.stack(losses).mean()
        return params, opt_state, metrics

    return train_step


def make_dp_compressed_train_step(model, opt_cfg: AdamConfig,
                                  group: Optional[dist.ProcessGroup] = None):
    """Data-parallel train step with the int8-compressed gradient
    all-gather + error feedback of ``runtime.compression``, run by every
    rank of ``group`` (none: one card) on its own slice of the global
    batch, params and moments replicated.

    ``opt_state`` carries an ``err`` tree: this rank's EF residuals
    (``runtime.compression.init_error_state(params, ranks)``; the
    reference's global ``err`` leaf is the ranks' segments concatenated
    along axis 0, ``init_error_state_global``)."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model.loss, params, batch)
        grads, new_err = tree_compressed_psum_mean(grads, opt_state["err"],
                                                   group)
        n = group_size(group)
        if n > 1:
            dist.all_reduce(loss, group=group)
            loss = loss / n
        inner = {k: v for k, v in opt_state.items() if k != "err"}
        params, inner, metrics = adam_update(
            opt_cfg, params, grads, inner,
            generator=_sround_generator(opt_cfg, opt_state["step"]))
        metrics["loss"] = loss
        return params, {**inner, "err": new_err}, metrics

    return train_step


def init_error_state_global(params, axis_size: int):
    """Global-view EF residuals, the reference's layout: the per-rank
    segments concatenated along axis 0 (with one rank, the rank's own)."""
    per_rank = init_error_state(params, axis_size)
    return tree_unflatten(params, [e.repeat(axis_size)
                                   for e in tree_leaves(per_rank)])


def make_prefill_step(model):
    def prefill_step(params, batch, capacity=None):
        return model.prefill(params, batch, capacity)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, token, pos):
        return model.decode(params, cache, token, pos)

    return decode_step
