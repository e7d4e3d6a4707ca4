"""Attention + FFN block param declarations and apply functions.

Shared by every transformer-family model (dense, MoE, hybrid, enc-dec,
VLM). Weights are declared at head granularity, as the reference declares
them: wq is (L, d_model, n_heads, head_dim), so a parameter tree crosses
between the packages leaf for leaf.

Two paths run only under an installed activation context, as in the
reference: the batch-split attention (``_batch_split_attention``, where
the heads do not divide the model axis) and the logits' layout constraint
(vocab-sharded over "model", ``constrain_logical``). Without a context
both are no-ops.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (apply_rope, attention, clamped_start,
                                       layer_norm, rms_norm)
from repro_torch.models.params import Decl
from repro_torch.runtime import spmd
from repro_torch.runtime.sharding import (activation_context_mesh,
                                          activation_context_rules,
                                          attn_batch_split_ok,
                                          attn_needs_batch_reshard,
                                          constrain_logical, mesh_axes)


def _lead(L: int) -> tuple:
    return (L,) if L else ()


def _ll(L: int) -> tuple:
    return ("layers",) if L else ()


def proj_in(x, w):
    """einsum("bsd,dhk->bshk"): x (B,S,d) times w (d,H,k)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def proj_out(o, w):
    """einsum("bshk,hkd->bsd"): o (B,S,H,k) times w (H,k,d)."""
    return o.flatten(-2) @ w.reshape(-1, w.shape[-1])


# ------------------------------------------------------------ attention ----
def attn_decls(cfg: ArchConfig, L: int, cross: bool = False) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead, ll = _lead(L), _ll(L)
    out = {
        "wq": Decl(lead + (d, H, hd), ll + ("embed", "qheads", "headdim")),
        "wk": Decl(lead + (d, K, hd), ll + ("embed", "kvheads", "headdim")),
        "wv": Decl(lead + (d, K, hd), ll + ("embed", "kvheads", "headdim")),
        "wo": Decl(lead + (H, hd, d), ll + ("qheads", "headdim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        out["bq"] = Decl(lead + (H, hd), ll + ("qheads", "headdim"), init="zeros")
        out["bk"] = Decl(lead + (K, hd), ll + ("kvheads", "headdim"), init="zeros")
        out["bv"] = Decl(lead + (K, hd), ll + ("kvheads", "headdim"), init="zeros")
    if cfg.qk_norm and not cross:
        out["q_norm"] = Decl(lead + (hd,), ll + ("headdim",), init="zeros")
        out["k_norm"] = Decl(lead + (hd,), ll + ("headdim",), init="zeros")
    return out


def qkv_project(cfg: ArchConfig, p: dict, x, pos):
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,K,hd), rope applied."""
    q = proj_in(x, p["wq"])
    k = proj_in(x, p["wk"])
    v = proj_in(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def _batch_split_attention(fn, q, k, v):
    """When the model axis cannot split the heads, attention would run
    replicated over it. The residual stream is replicated over "model"
    (sharded over the data axes only), so each model rank takes ITS 1/M
    slice of its data shard's batch, runs the core attention on it, and
    the outputs are all-gathered over "model" along the batch. Needs the
    per-data-shard batch to divide the model axis (the caller guards)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, rules = activation_context_mesh(), activation_context_rules()
    sizes = mesh_axes(mesh)
    dp = {a: Shard(0) for a in rules.dp_axes if a in sizes}
    pl = spmd.axis_placements(mesh, dp, Replicate())
    grad = spmd.axis_placements(mesh, dp, Partial())
    ql, kl, vl = (spmd.local_view(t, mesh, pl, grad) for t in (q, k, v))
    per = ql.shape[0] // sizes["model"]
    lo = mesh.get_local_rank("model") * per
    o = fn(ql[lo:lo + per], kl[lo:lo + per], vl[lo:lo + per])
    o = spmd.all_gather(o, mesh, "model", dim=0)
    return spmd.from_local(o, mesh, pl, q)


def attn_apply(cfg: ArchConfig, p: dict, x, *, pos, kind="causal", window=0,
               prefix_len=0):
    """Full-sequence self attention (train / prefill). Returns (out, k, v)."""
    q, k, v = qkv_project(cfg, p, x, pos)
    core = partial(attention, q_pos=pos, kind=kind, window=window,
                   prefix_len=prefix_len, chunk=cfg.attn_chunk,
                   softcap=cfg.logits_softcap)
    if attn_needs_batch_reshard(cfg.n_heads) and \
            attn_batch_split_ok(q.shape[0]):
        o = _batch_split_attention(core, q, k, v)
    else:
        o = core(q, k, v)
    return proj_out(o, p["wo"]), k, v


def attn_decode(cfg: ArchConfig, p: dict, x, cache_k, cache_v, pos: int, *,
                kind="causal", window=0, prefix_len=0, ring: bool = False):
    """One-token decode. x: (B,1,d). cache_k/v: (B,Smax,K,hd), written in
    place at the token's slot (the reference donates the cache).

    ``ring=True`` treats the cache as a ring buffer of size Smax (local
    attention): slot = pos % Smax and positions are tracked explicitly.
    The slot is clamped into the cache, as ``dynamic_update_slice`` clamps.
    Returns (out, cache_k, cache_v).
    """
    Smax = cache_k.shape[1]
    dev = x.device
    rp = torch.full((1,), pos, dtype=torch.int32, device=dev)
    q, k, v = qkv_project(cfg, p, x, rp)
    slot = (pos % Smax) if ring else pos
    w = clamped_start(slot, 1, Smax)
    cache_k[:, w] = k[:, 0].to(cache_k.dtype)
    cache_v[:, w] = v[:, 0].to(cache_v.dtype)
    if ring:
        idx = torch.arange(Smax, dtype=torch.int32, device=dev)
        # absolute position stored in each slot given current write at `slot`
        kv_pos = pos - torch.remainder(slot - idx, Smax)
        kv_valid = kv_pos >= 0
    else:
        kv_pos = torch.arange(Smax, dtype=torch.int32, device=dev)
        kv_valid = None  # causal mask handles the unwritten tail
    o = attention(q, cache_k, cache_v, q_pos=rp, kv_pos=kv_pos,
                  kv_valid=kv_valid, kind=kind, window=window,
                  prefix_len=prefix_len, chunk=cfg.attn_chunk,
                  softcap=cfg.logits_softcap)
    return proj_out(o, p["wo"]), cache_k, cache_v


# --------------------------------------------------------------- ffn -------
def ffn_decls(cfg: ArchConfig, L: int, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    lead, ll = _lead(L), _ll(L)
    out = {"w1": Decl(lead + (d, ff), ll + ("embed", "ffn")),
           "w2": Decl(lead + (ff, d), ll + ("ffn", "embed"))}
    if cfg.ffn_kind in ("swiglu", "geglu"):
        out["w3"] = Decl(lead + (d, ff), ll + ("embed", "ffn"))
    return out


def kv_cache_decls(cfg: ArchConfig, L: int, batch: int, capacity: int,
                   dtype: str = "bfloat16") -> dict:
    shape = (L, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    logical = ("layers", "batch", "seq", "kvheads", "headdim_tp")
    return {"k": Decl(shape, logical, init="zeros", dtype=dtype),
            "v": Decl(shape, logical, init="zeros", dtype=dtype)}


# -------------------------------------------------------------- norm -------
def norm_decls(cfg: ArchConfig, L: int) -> dict:
    lead, ll = _lead(L), _ll(L) + ("embed",)
    if cfg.norm_kind == "layer":
        return {"w": Decl(lead + (cfg.d_model,), ll, init="ones"),
                "b": Decl(lead + (cfg.d_model,), ll, init="zeros")}
    return {"w": Decl(lead + (cfg.d_model,), ll, init="zeros")}


def norm_apply(cfg: ArchConfig, p: dict, x):
    if cfg.norm_kind == "layer":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


# ------------------------------------------------------------- embed -------
def embed_decls(cfg: ArchConfig) -> dict:
    out = {"embed": Decl((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                         init="embed")}
    if not cfg.tie_embeddings:
        out["unembed"] = Decl((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    out["final_norm"] = norm_decls(cfg, 0)
    return out


def embed_tokens(params, tokens, dtype):
    return params["embed"][tokens].to(getattr(torch, dtype))


def logits_out(cfg: ArchConfig, params, x):
    if cfg.tie_embeddings:
        out = x @ params["embed"].to(x.dtype).t()
    else:
        out = x @ params["unembed"].to(x.dtype)
    # keep the (B, S, V) logits vocab-sharded over the model axis; a no-op
    # without an installed activation context
    return constrain_logical(out, ("batch", None, "vocab"))
