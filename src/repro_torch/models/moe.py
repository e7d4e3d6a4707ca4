"""Token-choice top-k MoE (moonshot 64e/top-6, kimi-k2 384e/top-8).

Dispatch is sort-based with static capacity, the reference's dense path
(``_moe_apply_dense``): a stable sort of the (token, choice) pairs by
expert, a capacity drop of each expert's overflow, a scatter into an
(E, C, d) buffer with a drop slot at E*C, grouped expert products, and a
weighted scatter-add back to the tokens. DeepSeek-V3-style extras used by
both MoE archs: leading dense layer(s) and always-on shared expert(s).

The reference's expert-parallel path (``_moe_apply_ep``) runs only on a
mesh whose model axis divides the experts; without one the reference takes
this dense path too. ``torch.topk`` does not promise the lower index on a
tie (``lax.top_k`` does), so the top-k is a stable descending sort; the
dispatch sort is stable as ``jnp.argsort`` is. The combine is
``index_add_``, which on the card is atomic and unordered: its sums hold to
a tolerance there, not to bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (cast_tree, ffn_apply, gelu_tanh, silu,
                                       softmax_xent)
from repro_torch.models.params import Decl
from repro_torch.models.transformer import (DenseLM, _maybe_remat, maybe_scan,
                                            tree_unbind)


def expert_ffn_decls(cfg: ArchConfig, L: int) -> dict:
    m = cfg.moe
    d, ff, E = cfg.d_model, m.d_ff_expert, m.n_experts
    lead = (L,) if L else ()
    out = {"w1": Decl(lead + (E, d, ff)), "w2": Decl(lead + (E, ff, d))}
    if cfg.ffn_kind in ("swiglu", "geglu"):
        out["w3"] = Decl(lead + (E, d, ff))
    return out


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.experts_per_token * n_tokens * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # >=8, rounded up to a multiple of 8


def route(cfg: ArchConfig, probs):
    """The dispatch plan of router probabilities ``probs`` (T, E): the
    normalized top-k gates, the expert ids, the stable sort ``order`` of
    the T*k (token, choice) pairs by expert, the ``keep`` mask of pairs
    within their expert's capacity (in sorted order) and each pair's
    buffer row ``dest`` (E*C: the drop slot)."""
    m = cfg.moe
    T, E = probs.shape
    k = m.experts_per_token
    C = capacity(cfg, T)
    gate, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_ids = gate[:, :k], expert_ids[:, :k]           # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_e = expert_ids.reshape(-1)                             # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=probs.device))
    seg_pos = torch.arange(T * k, device=probs.device) - first[sorted_e]
    keep = seg_pos < C
    dest = torch.where(keep, sorted_e * C + seg_pos, E * C)
    return {"gate": gate, "expert_ids": expert_ids, "order": order,
            "keep": keep, "dest": dest, "capacity": C}


def moe_apply(cfg: ArchConfig, p: dict, x):
    """x: (B, S, d) -> (y, aux_loss). p: router + experts (+ shared)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    k = m.experts_per_token
    E = m.n_experts

    xf = x.reshape(T, d)
    router_logits = xf.float() @ p["router"].float()
    probs = torch.softmax(router_logits, dim=-1)                # (T, E)
    r = route(cfg, probs)
    C, order, keep, dest = r["capacity"], r["order"], r["keep"], r["dest"]
    token_idx = torch.div(order, k, rounding_mode="floor")

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xf[token_idx]
    buf = buf[:-1].reshape(E, C, d)

    # ---- expert compute (grouped products) -----------------------------
    w = p["experts"]
    if "w3" in w:
        act = silu if cfg.ffn_kind == "swiglu" else gelu_tanh
        h = act(torch.bmm(buf, w["w1"])) * torch.bmm(buf, w["w3"])
    else:
        h = gelu_tanh(torch.bmm(buf, w["w1"]))
    out_buf = torch.bmm(h, w["w2"]).reshape(E * C, d)

    # ---- combine -------------------------------------------------------
    contrib = torch.where(keep[:, None],
                          out_buf[torch.clamp(dest, max=E * C - 1)],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    contrib = contrib * r["gate"].reshape(-1)[order][:, None].to(x.dtype)
    yf = torch.zeros((T, d), dtype=x.dtype, device=x.device
                     ).index_add_(0, token_idx, contrib)
    y = yf.reshape(B, S, d)

    if "shared" in p:
        y = y + ffn_apply(x, p["shared"], cfg.ffn_kind)

    # ---- load-balance aux (Switch): E * sum_i f_i * p_i ----------------
    me = probs.mean(0)                                          # (E,)
    ce = F.one_hot(r["expert_ids"][:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)
    return y, aux


class MoELM(DenseLM):
    """Dense attention + MoE FFN; leading ``first_k_dense`` layers dense."""

    def moe_layer_decls(self, L: int) -> dict:
        cfg = self.cfg
        m = cfg.moe
        out = {
            "attn_norm": blocks.norm_decls(cfg, L),
            "attn": blocks.attn_decls(cfg, L),
            "ffn_norm": blocks.norm_decls(cfg, L),
            "router": Decl(((L,) if L else ()) + (cfg.d_model, m.n_experts)),
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
