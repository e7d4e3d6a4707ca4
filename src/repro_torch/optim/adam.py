"""AdamW from scratch on nested dicts of tensors, with the large-model
options of the reference:

* global-norm gradient clipping;
* linear warmup + cosine decay schedule;
* **int8 row-quantized moments** (per last-dim row absmax), 8x fewer
  optimizer bytes;
* **stochastic rounding** for bf16 parameter stores, so bf16 masters do
  not stall at small update sizes; its draws come from a
  ``torch.Generator``.

Moment trees are declared with the same ``Decl`` machinery as parameters
(``opt_state_decls``), so ``models.params.init_params`` builds them. The
arithmetic is the reference's, operation for operation, in float32.
Leaves are visited in sorted-key order, the reference's tree order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.params import Decl


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"     # "float32" | "int8"
    stochastic_round: bool = False    # for bf16 param stores


def schedule(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an integer tensor): linear warmup over
    ``warmup_steps``, then cosine decay to 0 at ``total_steps``."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


# ------------------------------------------------------- int8 moments ------
def _quant_rows(x: torch.Tensor):
    """Per last-dim-row absmax int8 quantization. x f32 -> (q, scale)."""
    scale = torch.amax(x.abs(), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    # torch.round rounds half to even, as the reference does
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _dequant_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def _moment_decl(d: Decl, moment_dtype: str):
    """Decl(s) for one moment tensor of one param Decl."""
    if moment_dtype == "int8":
        return {"q": Decl(d.shape, init="zeros", dtype="int8"),
                "scale": Decl(d.shape[:-1], init="zeros", dtype="float32")}
    return Decl(d.shape, init="zeros", dtype="float32")


def _map_decls(fn, decls):
    if isinstance(decls, Decl):
        return fn(decls)
    return {k: _map_decls(fn, v) for k, v in decls.items()}


def opt_state_decls(param_decls, cfg: AdamConfig) -> dict:
    """{"m", "v", "step"} Decl tree for the params' Decl tree."""
    def moments():
        return _map_decls(lambda d: _moment_decl(d, cfg.moment_dtype),
                          param_decls)
    return {"m": moments(), "v": moments(),
            "step": Decl((), init="zeros", dtype="int32")}


def _read_moment(mo, cfg: AdamConfig, square: bool) -> torch.Tensor:
    if cfg.moment_dtype == "int8":
        x = _dequant_rows(mo["q"], mo["scale"])
        return torch.square(x) if square else x
    return mo


def _write_moment(x: torch.Tensor, cfg: AdamConfig, square: bool):
    if cfg.moment_dtype == "int8":
        if square:
            x = torch.sqrt(torch.clamp(x, min=0.0))
        q, s = _quant_rows(x)
        return {"q": q, "scale": s}
    return x


def bf16_neighbour(near: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The next bf16 value after ``near`` (bf16) towards +inf where ``up``,
    else towards -inf: one step of the int16 bit pattern, which is exact
    (the magnitude bits of a finite bf16 count its lattice points)."""
    bits = near.view(torch.int16)
    # a step up grows a positive value's magnitude and shrinks a
    # negative one's; from zero both lead to the smallest subnormal
    grow = up == (near > 0)
    stepped = torch.where(grow, bits + 1, bits - 1)
    tiny = torch.where(up, torch.ones_like(bits),
                       torch.full_like(bits, -32767))    # 0x0001, 0x8001
    return torch.where(near == 0, tiny, stepped).view(torch.bfloat16)


def _sround(x32: torch.Tensor, generator: torch.Generator, out_dtype):
    """Stochastic rounding f32 -> bf16: round to a neighbour on the bf16
    lattice with probability by distance (an f32 nextafter would collapse
    back to the same bf16 value and the rounding would never fire)."""
    if out_dtype != torch.bfloat16:
        return x32.to(out_dtype)
    near = x32.to(torch.bfloat16)                # round-to-nearest anchor
    near32 = near.to(torch.float32)
    other = bf16_neighbour(near, x32 > near32).to(torch.float32)
    gap = torch.abs(other - near32)
    pfrac = torch.where(gap > 0, torch.abs(x32 - near32)
                        / torch.clamp(gap, min=1e-38), 0.0)
    u = torch.rand(x32.shape, generator=generator, device=x32.device)
    return torch.where(u < pfrac, other, near32).to(torch.bfloat16)


# -------------------------------------------------------------- trees ------
def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (the reference's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_flatten_up_to(structure, tree) -> list:
    """``tree``'s subtrees at the leaf positions of ``structure``."""
    if isinstance(structure, dict):
        return [x for k in sorted(structure)
                for x in tree_flatten_up_to(structure[k], tree[k])]
    return [tree]


def tree_unflatten(structure, leaves) -> dict:
    """Inverse of ``tree_flatten_up_to`` for ``structure``'s shape."""
    return _build(structure, iter(leaves))


def _build(structure, it):
    # a module-level recursion: a recursive closure would form a reference
    # cycle holding ``leaves`` (a whole gradient or parameter set) until
    # the cyclic garbage collector runs
    if isinstance(structure, dict):
        return {k: _build(structure[k], it) for k in sorted(structure)}
    return next(it)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adam_update(cfg: AdamConfig, params, grads, opt_state, *,
                generator: Optional[torch.Generator] = None):
    """One AdamW step. Returns (new_params, new_opt_state, metrics) with
    metrics {"grad_norm", "lr"}. ``generator`` drives the stochastic
    rounding of bf16 params (with ``cfg.stochastic_round``)."""
    step = opt_state["step"]
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    lr = schedule(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    leaves_p = tree_leaves(params)
    leaves_g = tree_flatten_up_to(params, grads)
    leaves_m = tree_flatten_up_to(params, opt_state["m"])
    leaves_v = tree_flatten_up_to(params, opt_state["v"])

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(leaves_p, leaves_g, leaves_m, leaves_v):
        g32 = g.to(torch.float32) * clip
        m32 = _read_moment(m, cfg, square=False)
        v32 = _read_moment(v, cfg, square=True)
        m32 = cfg.b1 * m32 + (1.0 - cfg.b1) * g32
        v32 = cfg.b2 * v32 + (1.0 - cfg.b2) * torch.square(g32)
        upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (upd + cfg.weight_decay * p32)
        if (cfg.stochastic_round and p.dtype == torch.bfloat16
                and generator is not None):
            new_p.append(_sround(p32, generator, p.dtype))
        else:
            new_p.append(p32.to(p.dtype))
        new_m.append(_write_moment(m32, cfg, square=False))
        new_v.append(_write_moment(v32, cfg, square=True))

    new_state = {"m": tree_unflatten(params, new_m),
                 "v": tree_unflatten(params, new_v),
                 "step": step + 1}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return tree_unflatten(params, new_p), new_state, metrics
