"""Attention + FFN block param declarations and apply functions.

Shared by every transformer-family model (dense, MoE, hybrid, enc-dec,
VLM). Weights are declared at head granularity, as the reference declares
them: wq is (L, d_model, n_heads, head_dim), so a parameter tree crosses
between the packages leaf for leaf.

Two reference paths exist only for a TPU mesh and are not here: the
batch-split attention (``_batch_split_attention``) and the logits' layout
constraint (``constrain_logical``); without a mesh both are no-ops in the
reference too.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (apply_rope, attention, clamped_start,
                                       layer_norm, rms_norm)
from repro_torch.models.params import Decl


def _lead(L: int) -> tuple:
    return (L,) if L else ()


def proj_in(x, w):
    """einsum("bsd,dhk->bshk"): x (B,S,d) times w (d,H,k)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def proj_out(o, w):
    """einsum("bshk,hkd->bsd"): o (B,S,H,k) times w (H,k,d)."""
    return o.flatten(-2) @ w.reshape(-1, w.shape[-1])


# ------------------------------------------------------------ attention ----
def attn_decls(cfg: ArchConfig, L: int, cross: bool = False) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = _lead(L)
    out = {
        "wq": Decl(lead + (d, H, hd)),
        "wk": Decl(lead + (d, K, hd)),
        "wv": Decl(lead + (d, K, hd)),
        "wo": Decl(lead + (H, hd, d)),
    }
    if cfg.qkv_bias and not cross:
        out["bq"] = Decl(lead + (H, hd), init="zeros")
        out["bk"] = Decl(lead + (K, hd), init="zeros")
        out["bv"] = Decl(lead + (K, hd), init="zeros")
    if cfg.qk_norm and not cross:
        out["q_norm"] = Decl(lead + (hd,), init="zeros")
        out["k_norm"] = Decl(lead + (hd,), init="zeros")
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


def attn_apply(cfg: ArchConfig, p: dict, x, *, pos, kind="causal", window=0,
               prefix_len=0):
    """Full-sequence self attention (train / prefill). Returns (out, k, v)."""
    q, k, v = qkv_project(cfg, p, x, pos)
    o = attention(q, k, v, q_pos=pos, kind=kind, window=window,
                  prefix_len=prefix_len, chunk=cfg.attn_chunk,
                  softcap=cfg.logits_softcap)
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
    lead = _lead(L)
    out = {"w1": Decl(lead + (d, ff)), "w2": Decl(lead + (ff, d))}
    if cfg.ffn_kind in ("swiglu", "geglu"):
        out["w3"] = Decl(lead + (d, ff))
    return out


def kv_cache_decls(cfg: ArchConfig, L: int, batch: int, capacity: int,
                   dtype: str = "bfloat16") -> dict:
    shape = (L, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {"k": Decl(shape, init="zeros", dtype=dtype),
            "v": Decl(shape, init="zeros", dtype=dtype)}


# -------------------------------------------------------------- norm -------
def norm_decls(cfg: ArchConfig, L: int) -> dict:
    lead = _lead(L)
    if cfg.norm_kind == "layer":
        return {"w": Decl(lead + (cfg.d_model,), init="ones"),
                "b": Decl(lead + (cfg.d_model,), init="zeros")}
    return {"w": Decl(lead + (cfg.d_model,), init="zeros")}


def norm_apply(cfg: ArchConfig, p: dict, x):
    if cfg.norm_kind == "layer":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


# ------------------------------------------------------------- embed -------
def embed_decls(cfg: ArchConfig) -> dict:
    out = {"embed": Decl((cfg.vocab_size, cfg.d_model), init="embed")}
    if not cfg.tie_embeddings:
        out["unembed"] = Decl((cfg.d_model, cfg.vocab_size))
    out["final_norm"] = norm_decls(cfg, 0)
    return out


def embed_tokens(params, tokens, dtype):
    return params["embed"][tokens].to(getattr(torch, dtype))


def logits_out(cfg: ArchConfig, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).t()
    return x @ params["unembed"].to(x.dtype)
