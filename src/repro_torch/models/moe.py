"""Token-choice top-k MoE (moonshot 64e/top-6, kimi-k2 384e/top-8).

Dispatch is sort-based with static capacity: a stable sort of the (token,
choice) pairs by expert, a capacity drop of each expert's overflow, a
scatter into an (E, C, d) buffer with a drop slot at E*C, grouped expert
products, and a weighted scatter-add back to the tokens.
DeepSeek-V3-style extras used by both MoE archs: leading dense layer(s)
and always-on shared expert(s).

Two paths, routed as the reference routes them (``moe_apply``): with an
activation context whose model axis is above 1 and divides the experts,
the expert-parallel path (``_moe_apply_ep``): the residual stream is
replicated over "model", experts are sharded over it, each model rank
dispatches its own experts' tokens locally (its data shard's tokens, the
capacity from their count), and the partial outputs are summed over
"model"; otherwise the dense path (``_moe_apply_dense``). The EP body is
per-rank code with explicit collectives (``runtime.spmd``).

``torch.topk`` does not promise the lower index on a tie (``lax.top_k``
does), so the top-k is a stable descending sort; the dispatch sort is
stable as ``jnp.argsort`` is. The combine is ``index_add_``, which on the
card is atomic and unordered: its sums hold to a tolerance there, not to
bits.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (cast_tree, ffn_apply, gelu_tanh, silu,
                                       softmax_xent)
from repro_torch.models.params import Decl
from repro_torch.models.transformer import (DenseLM, _maybe_remat, maybe_scan,
                                            tree_unbind)
from repro_torch.runtime import spmd
from repro_torch.runtime.sharding import (activation_context_mesh,
                                          activation_context_rules, mesh_axes)


def expert_ffn_decls(cfg: ArchConfig, L: int) -> dict:
    m = cfg.moe
    d, ff, E = cfg.d_model, m.d_ff_expert, m.n_experts
    lead = (L,) if L else ()
    ll = ("layers",) if L else ()
    out = {"w1": Decl(lead + (E, d, ff), ll + ("experts", "embed", "ffn")),
           "w2": Decl(lead + (E, ff, d), ll + ("experts", "ffn", "embed"))}
    if cfg.ffn_kind in ("swiglu", "geglu"):
        out["w3"] = Decl(lead + (E, d, ff), ll + ("experts", "embed", "ffn"))
    return out


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.experts_per_token * n_tokens * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # >=8, rounded up to a multiple of 8


def route(cfg: ArchConfig, probs, e_base: int = 0,
          n_local: Optional[int] = None, capacity_rows: Optional[int] = None):
    """The dispatch plan of router probabilities ``probs`` (T, E) for the
    experts [e_base, e_base + n_local) (default: all of them) at
    ``capacity_rows`` rows each (default: ``capacity(cfg, T)``): the
    normalized top-k gates, the expert ids, the stable sort ``order`` of
    the T*k (token, choice) pairs by local expert (pairs routed elsewhere
    last), the ``keep`` mask of pairs within their expert's capacity (in
    sorted order) and each pair's buffer row ``dest`` (n_local*C: the drop
    slot)."""
    T, E = probs.shape
    k = cfg.moe.experts_per_token
    n = E if n_local is None else n_local
    C = capacity(cfg, T) if capacity_rows is None else capacity_rows
    dev = probs.device
    gate, expert_ids = top_k(cfg, probs)                        # (T, k)

    local_e = expert_ids.reshape(-1) - e_base                   # (T*k,)
    sort_key = torch.where((local_e >= 0) & (local_e < n), local_e, n)
    order = torch.argsort(sort_key, stable=True)
    sorted_e = sort_key[order]
    first = torch.searchsorted(sorted_e, torch.arange(n, device=dev))
    seg_pos = torch.arange(T * k, device=dev) \
        - first[torch.clamp(sorted_e, max=n - 1)]
    keep = (sorted_e < n) & (seg_pos < C)
    dest = torch.where(keep, sorted_e * C + seg_pos, n * C)
    return {"gate": gate, "expert_ids": expert_ids, "order": order,
            "keep": keep, "dest": dest, "capacity": C}


def top_k(cfg: ArchConfig, probs):
    """The normalized top-k gates and their expert ids, (T, k) each: a
    stable descending sort, so a tie keeps the lower expert id."""
    k = cfg.moe.experts_per_token
    gate, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_ids = gate[:, :k], expert_ids[:, :k]
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), expert_ids


def _experts(cfg: ArchConfig, buf, w1, w2, w3):
    """The grouped expert FFN: buf (E, C, d) -> (E, C, d)."""
    if w3 is not None:
        act = silu if cfg.ffn_kind == "swiglu" else gelu_tanh
        h = act(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    else:
        h = gelu_tanh(torch.bmm(buf, w1))
    return torch.bmm(h, w2)


def _aux(cfg: ArchConfig, probs, expert_ids):
    """The Switch load-balance loss E * sum_i f_i * p_i."""
    E = cfg.moe.n_experts
    me = probs.mean(0)                                          # (E,)
    ce = F.one_hot(expert_ids[:, 0], E).float().mean(0)
    return E * torch.sum(me * ce)


def moe_apply(cfg: ArchConfig, p: dict, x):
    """x: (B, S, d) -> (y, aux_loss). p: router + experts (+ shared).

    With an activation context installed whose model axis is above 1 and
    divides the experts, the expert-parallel path; else the dense one."""
    mesh = activation_context_mesh()
    M = mesh_axes(mesh).get("model", 1) if mesh is not None else 1
    if M > 1 and cfg.moe.n_experts % M == 0:
        return _moe_apply_ep(cfg, p, x, mesh, activation_context_rules())
    return _moe_apply_dense(cfg, p, x)


def _dispatch_compute_combine(cfg: ArchConfig, xf, probs, w: dict,
                              e_base: int = 0, n_local: Optional[int] = None,
                              capacity_rows: Optional[int] = None):
    """Sort-based dispatch restricted to experts [e_base, e_base+n_local)
    (``route``; default: all), grouped products of their weights ``w``
    (w1, w2[, w3], n_local experts each), weighted combine. xf: (T, d).
    Returns the (T, d) partial output (zeros for tokens routed elsewhere)
    and the plan."""
    T, d = xf.shape
    k = cfg.moe.experts_per_token
    dev = xf.device
    r = route(cfg, probs, e_base, n_local, capacity_rows)
    n, C = w["w1"].shape[0], r["capacity"]
    order, keep, dest = r["order"], r["keep"], r["dest"]
    token_idx = torch.div(order, k, rounding_mode="floor")

    buf = torch.zeros((n * C + 1, d), dtype=xf.dtype, device=dev)
    buf[dest] = xf[token_idx]
    out_buf = _experts(cfg, buf[:-1].reshape(n, C, d), w["w1"], w["w2"],
                       w.get("w3")).reshape(n * C, d)

    contrib = torch.where(keep[:, None],
                          out_buf[torch.clamp(dest, max=n * C - 1)],
                          torch.zeros((), dtype=xf.dtype, device=dev))
    contrib = contrib * r["gate"].reshape(-1)[order][:, None].to(xf.dtype)
    return torch.zeros((T, d), dtype=xf.dtype, device=dev
                       ).index_add_(0, token_idx, contrib), r


def _moe_apply_ep(cfg: ArchConfig, p: dict, x, mesh, rules):
    """Explicit expert-parallel MoE, the reference's ``shard_map`` body run
    by every rank. Operands come in at the reference's specs: x (B, S, d)
    sharded over the data axes and replicated over "model"; the router
    gathered over the FSDP axis (axis 0) and "model" (axis 1); w1/w3 over
    the FSDP axis on axis 1 and w2 on axis 2, where d divides it and the
    rules shard FSDP, experts left sharded over "model". Each rank
    dispatches its data shard's tokens to its E/M experts at the capacity
    of its T_loc tokens, and the partial outputs are summed over "model".

    The aux: each rank computes it from its own probabilities. Its value
    is data coordinate 0's, as the reference's unchecked ``out_specs=P()``
    returns device 0's; its gradient is that of the mean over the data
    shards, as the reference's transpose gives. The shared experts are
    added after the sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    m = cfg.moe
    sizes = mesh_axes(mesh)
    B, S, d = x.shape
    M = sizes["model"]
    E_loc = m.n_experts // M
    dp = [a for a in rules.dp_axes if a in sizes]
    dpn = int(np.prod([sizes[a] for a in dp]))
    T_loc = (B // dpn) * S
    cap_rows = max(8, -(- int(m.experts_per_token * T_loc
                              * m.capacity_factor / m.n_experts) // 8) * 8)

    x_pl = spmd.axis_placements(mesh, {a: Shard(0) for a in dp}, Replicate())
    # each model rank uses x, the router and its experts for its own
    # experts only: their gradients are partial sums over the other axes
    x_grad = spmd.axis_placements(mesh, {a: Shard(0) for a in dp}, Partial())
    repl = [Replicate()] * mesh.ndim
    w_pl = spmd.axis_placements(mesh, {"model": Shard(0)}, Replicate())
    w_grad = spmd.axis_placements(mesh, {"model": Shard(0)}, Partial())

    xl = spmd.local_view(x, mesh, x_pl, x_grad)
    router = spmd.local_view(p["router"], mesh, repl, [Partial()] * mesh.ndim)
    w = {n: spmd.local_view(t, mesh, w_pl, w_grad)
         for n, t in p["experts"].items()}

    e_base = mesh.get_local_rank("model") * E_loc
    xf = xl.reshape(-1, d)
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    y, r = _dispatch_compute_combine(cfg, xf, probs, w, e_base, E_loc,
                                     cap_rows)
    y = spmd.psum(y, mesh, "model")

    aux = _aux(cfg, probs, r["expert_ids"])
    mean = aux / mesh.size()
    for a in mesh.mesh_dim_names:          # every rank's share: the mean
        mean = spmd.psum(mean, mesh, a)
    aux = mean + (spmd.first_coordinate(aux, mesh, dp) - mean).detach()

    y = spmd.from_local(y.reshape(xl.shape), mesh, x_pl, x)
    aux = spmd.from_local(aux, mesh, repl, x, shape=())
    if "shared" in p:
        y = y + ffn_apply(x, p["shared"], cfg.ffn_kind)
    return y, aux


def _moe_apply_dense(cfg: ArchConfig, p: dict, x):
    """The dense path: sort-based dispatch with static capacity over all
    experts and tokens."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)  # (T, E)
    yf, r = _dispatch_compute_combine(cfg, xf, probs, p["experts"])
    y = yf.reshape(B, S, d)
    if "shared" in p:
        y = y + ffn_apply(x, p["shared"], cfg.ffn_kind)
    return y, _aux(cfg, probs, r["expert_ids"])


class MoELM(DenseLM):
    """Dense attention + MoE FFN; leading ``first_k_dense`` layers dense."""

    def moe_layer_decls(self, L: int) -> dict:
        cfg = self.cfg
        m = cfg.moe
        out = {
            "attn_norm": blocks.norm_decls(cfg, L),
            "attn": blocks.attn_decls(cfg, L),
            "ffn_norm": blocks.norm_decls(cfg, L),
            "router": Decl(((L,) if L else ()) + (cfg.d_model, m.n_experts),
                           (("layers",) if L else ()) + ("embed", "experts")),
            "experts": expert_ffn_decls(cfg, L),
        }
        if m.n_shared_experts:
            shared_cfg = cfg.replace(d_ff=m.n_shared_experts * m.d_ff_expert)
            out["shared"] = blocks.ffn_decls(shared_cfg, L)
        return out

    def param_decls(self) -> dict:
        cfg = self.cfg
        m = cfg.moe
        n_moe = cfg.n_layers - m.first_k_dense
        out = {**blocks.embed_decls(cfg), "layers": self.moe_layer_decls(n_moe)}
        if m.first_k_dense:
            dense_cfg = cfg.replace(d_ff=m.d_ff_dense or cfg.d_ff)
            out["dense_layers"] = {
                "attn_norm": blocks.norm_decls(cfg, m.first_k_dense),
                "attn": blocks.attn_decls(cfg, m.first_k_dense),
                "ffn_norm": blocks.norm_decls(cfg, m.first_k_dense),
                "ffn": blocks.ffn_decls(dense_cfg, m.first_k_dense),
            }
        return out

    # -------------------------------------------------------------- fwd ----
    def _moe_layer_fwd(self, carry, lp, pos, collect_kv):
        cfg = self.cfg
        x, aux = carry
        h = blocks.norm_apply(cfg, lp["attn_norm"], x)
        o, k, v = blocks.attn_apply(cfg, lp["attn"], h, pos=pos)
        x = x + o
        h = blocks.norm_apply(cfg, lp["ffn_norm"], x)
        y, a = moe_apply(cfg, lp, h)
        ys = (k.to(torch.bfloat16), v.to(torch.bfloat16)) if collect_kv else None
        return (x + y, aux + a), ys

    def backbone(self, params, x, pos, collect_kv: bool = False):
        cfg = self.cfg
        kvs = []
        if cfg.moe.first_k_dense:
            dl = cast_tree(params["dense_layers"], cfg.dtype)
            for lp in tree_unbind(dl):
                x, ys = self._layer_fwd(x, lp, pos, collect_kv)
                kvs.append(ys)

        lp_all = cast_tree(params["layers"], cfg.dtype)

        def body(carry, lp):
            return self._moe_layer_fwd(carry, lp, pos, collect_kv)

        body = _maybe_remat(body, cfg)
        aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
        (x, aux), kv = maybe_scan(body, (x, aux0), lp_all, collect=collect_kv)
        if collect_kv and kvs:
            kv = tuple(torch.cat([torch.stack([t[j] for t in kvs]), kv[j]])
                       for j in range(2))
        x = blocks.norm_apply(cfg, params["final_norm"], x)
        self._last_aux = aux
        return x, kv

    def loss(self, params, batch):
        cfg = self.cfg
        x, pos, _ = self.embed_inputs(params, batch)
        x, _ = self.backbone(params, x, pos)
        logits = blocks.logits_out(cfg, params, x)
        return softmax_xent(logits, batch["labels"]) + \
            cfg.moe.router_aux_weight * self._last_aux

    # ------------------------------------------------------------ decode ---
    def decode(self, params, cache, token, pos: int):
        cfg = self.cfg
        pos = int(pos)
        nd = cfg.moe.first_k_dense
        x = blocks.embed_tokens(params, token, cfg.dtype)

        def body(x, xs, moe: bool):
            lp, ck, cv = xs
            h = blocks.norm_apply(cfg, lp["attn_norm"], x)
            o, _, _ = blocks.attn_decode(cfg, lp["attn"], h, ck, cv, pos)
            x = x + o
            h = blocks.norm_apply(cfg, lp["ffn_norm"], x)
            y = moe_apply(cfg, lp, h)[0] if moe else \
                ffn_apply(h, lp["ffn"], cfg.ffn_kind)
            return x + y, None

        if nd:
            x, _ = maybe_scan(lambda c, xs: body(c, xs, False), x,
                              (cast_tree(params["dense_layers"], cfg.dtype),
                               cache["k"][:nd], cache["v"][:nd]), collect=False)
        x, _ = maybe_scan(lambda c, xs: body(c, xs, True), x,
                          (cast_tree(params["layers"], cfg.dtype),
                           cache["k"][nd:], cache["v"][nd:]), collect=False)
        x = blocks.norm_apply(cfg, params["final_norm"], x)
        return cache, blocks.logits_out(cfg, params, x)
