"""int8 gradient compression with error feedback.

The data-parallel gradient all-reduce = reduce-scatter + all-gather. The
reduce-scatter stays exact (f32: partial sums must not saturate) and the
all-gather leg is compressed to int8 + per-row scales, cutting its wire
bytes ~4x. Quantization error is fed back: each rank remembers the
residual of its OWN scattered segment and adds it to the next step's
segment before quantizing (EF-SGD), which keeps the long-run gradient
unbiased.

The reference runs ``psum_scatter`` (f32) and ``all_gather`` (int8 with
f32 scales) inside ``shard_map`` over the data axis; here they are
``torch.distributed.reduce_scatter_tensor`` and
``all_gather_into_tensor`` on a process group. A group of one, or no
group at all (one card), makes both collectives identities; the int8
quantization and the error feedback still run, as in the reference's
one-device driver.

Usage, in every rank of ``group``:

    gseg, new_err = compressed_psum_mean(g, err, group)

State shape: one residual per leaf of the leaf's *scattered* shape
(padded size / ranks).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.optim.adam import tree_flatten_up_to, tree_leaves, tree_unflatten

_ROW = 256  # quantization row width


def quant_rows(x: torch.Tensor, dim: int = -1):
    """f32 -> (int8, f32 scale) with per-row absmax along ``dim``."""
    scale = torch.amax(x.abs(), dim=dim, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequant_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _flatten_pad(g: torch.Tensor, n: int):
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % n
    return F.pad(flat, (0, pad)), pad


def group_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """Ranks in ``group`` (the default group when None); 1 without an
    initialized process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def compressed_psum_mean(g: torch.Tensor, err: torch.Tensor,
                         group: Optional[dist.ProcessGroup] = None):
    """One leaf: mean-all-reduce over the ranks of ``group`` with an
    int8-compressed all-gather + error feedback. Returns (g_mean (full
    shape), new_err (scattered shape))."""
    n = group_size(group)
    flat, pad = _flatten_pad(g, n * _ROW)       # segments divisible by _ROW
    if n > 1:
        seg = flat.new_empty(flat.shape[0] // n)
        dist.reduce_scatter_tensor(seg, flat, op=dist.ReduceOp.SUM,
                                   group=group)
    else:
        seg = flat
    seg = seg / n                                              # exact RS mean
    seg = seg + err                                            # error feedback
    rows = seg.reshape(-1, _ROW)
    q, s = quant_rows(rows)
    deq = dequant_rows(q, s).reshape(seg.shape)
    new_err = seg - deq
    if n > 1:                                                  # int8 wire
        qg = q.new_empty((n * q.shape[0], _ROW))
        sg = s.new_empty((n * s.shape[0], 1))                  # f32 (1/256th)
        dist.all_gather_into_tensor(qg, q, group=group)
        dist.all_gather_into_tensor(sg, s, group=group)
        q, s = qg, sg
    full = dequant_rows(q, s).reshape(flat.shape)
    if pad:
        full = full[:-pad]
    return full.reshape(g.shape), new_err


def init_error_state(params, axis_size: int):
    """Residual tree matching the scattered segment shapes (zeros on each
    leaf's device)."""
    def one(p):
        flat = p.numel()
        block = axis_size * _ROW
        seg = (flat + (-flat) % block) // axis_size
        return torch.zeros((seg,), dtype=torch.float32, device=p.device)
    return tree_unflatten(params, [one(p) for p in tree_leaves(params)])


def tree_compressed_psum_mean(grads, err_state,
                              group: Optional[dist.ProcessGroup] = None):
    """``compressed_psum_mean`` over every leaf (sorted-key order, the
    reference's): (mean gradient tree, new residual tree)."""
    outs = [compressed_psum_mean(g.to(torch.float32), e, group)
            for g, e in zip(tree_leaves(grads),
                            tree_flatten_up_to(grads, err_state))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def wire_bytes_saved(n_params: int, axis_size: int) -> dict:
    """Analytic wire-byte model: per-rank bytes of the all-gather leg, f32
    vs int8 (+ scales)."""
    frac = (axis_size - 1) / axis_size
    f32 = 4 * n_params * frac
    int8 = (1 + 4 / 256) * n_params * frac
    return {"allgather_f32": f32, "allgather_int8": int8,
            "ratio": f32 / int8}
