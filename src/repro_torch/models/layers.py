"""Shared transformer building blocks (plain PyTorch, functional), the
reference's op for op.

Attention is the reference's chunked online softmax (flash-attention
algebra as a loop over KV chunks, each chunk padded to ``chunk`` slots), so
long prefill and decode keep O(seq * chunk) live memory. Masks: causal,
local window (recurrentgemma), prefix-LM (paligemma), full (whisper encoder
and cross-attention).

Where the reference asks a product for an f32 result
(``preferred_element_type=f32``) of narrower operands, the operands are
upcast (exact) and multiplied in f32: a bf16 matmul would round its
output. The activations are written as the reference's formulas, op by
op, with a Python scalar rounded to the tensor's type first as JAX's weak
typing does (``weak``): torch rounds each bf16 op's result as XLA does on
the CPU, so the bf16 chains round alike (``F.silu`` or ``F.gelu`` round
once and differ in about 40% of bf16 elements).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def weak(v: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX's weak typing sees it beside a ``dtype``
    array: rounded to that type."""
    return float(torch.tensor(v, dtype=dtype))


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def sigmoid(x):
    """``jax.nn.sigmoid`` (``lax.logistic``): 1 / (1 + exp(-x))."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * sigmoid(x)


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)``: its formula and constants."""
    c = weak(math.sqrt(2 / math.pi), x.dtype)
    cdf = weak(0.5, x.dtype) * (1.0 + torch.tanh(
        c * (x + weak(0.044715, x.dtype) * (x ** 3))))
    return x * cdf


def clamped_start(start: int, size: int, dim: int) -> int:
    """The start ``lax.dynamic_slice``/``dynamic_update_slice`` use: an
    out-of-range start is clamped so that ``size`` elements fit in
    ``dim`` (torch would raise)."""
    return min(max(start, 0), dim - size)


# ---------------------------------------------------------------- norms ----
def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


# ----------------------------------------------------------------- rope ----
def apply_rope(x, pos, theta: float):
    """x: (..., S, H, D) with D even; pos: (S,) or (B, S) int."""
    if theta <= 0.0:
        return x
    d2 = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        d2, dtype=torch.float32, device=x.device) / d2)
    ang = pos.float()[..., None] * freqs                  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def _mask(q_pos, kv_pos, kind: str, window: int, prefix_len: int):
    """(Sq, C) boolean allowed-matrix from position vectors."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    if kind == "causal":
        return k <= q
    if kind == "local":
        return (k <= q) & (q - k < window)
    if kind == "prefix":
        return (k <= q) | (k < prefix_len)
    if kind == "full":
        return torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    raise ValueError(kind)


def attention(q, k, v, *, q_pos, kv_pos=None, kv_valid=None, kind="causal",
              window: int = 0, prefix_len: int = 0, chunk: int = 1024,
              softcap: float = 0.0):
    """Chunked online-softmax GQA attention.

    q: (B, Sq, Hq, D);  k, v: (B, Skv, Hkv, D), Hq % Hkv == 0.
    q_pos: (Sq,) int absolute positions; kv_pos: (Skv,) (default arange).
    kv_valid: (Skv,) bool — False for ring-buffer/padded slots.
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    qh = (q.reshape(B, Sq, Hkv, G, D) * weak(D ** -0.5, q.dtype)).float()
    if kv_pos is None:
        kv_pos = torch.arange(Skv, dtype=torch.int32, device=dev)
    if kv_valid is None:
        kv_valid = torch.ones((Skv,), dtype=torch.bool, device=dev)

    # the last chunk is ragged: the reference pads KV to a chunk multiple
    # (static shapes), whose masked slots add exact zeros to l and acc
    # (and torch 2.11's DTensor mis-shards the pad on a 2-D mesh)
    nc = max(1, -(-Skv // chunk))

    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        kc, vc = k[:, sl], v[:, sl]
        logits = torch.einsum("bskgd,bckd->bskgc", qh, kc.float())
        if softcap > 0.0:
            logits = softcap * torch.tanh(logits / softcap)
        allowed = _mask(q_pos, kv_pos[sl], kind, window, prefix_len) \
            & kv_valid[sl][None, :]
        logits = logits.masked_fill(~allowed[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bskgc,bckd->bskgd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


# ---------------------------------------------------------------- ffn ------
def ffn_apply(x, p, kind: str):
    if kind in ("swiglu", "geglu"):
        act = silu if kind == "swiglu" else gelu_tanh
        h = act(x @ p["w1"]) * (x @ p["w3"])
        return h @ p["w2"]
    if kind == "gelu":
        return gelu_tanh(x @ p["w1"]) @ p["w2"]
    if kind == "relu2":
        return torch.square(torch.relu(x @ p["w1"])) @ p["w2"]
    raise ValueError(kind)


def cast_tree(tree, dtype):
    """Every floating leaf of a nested dict cast to ``dtype`` (a leaf
    already of that type is returned as it is, not copied)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if isinstance(tree, dict):
        return {k: cast_tree(v, dt) for k, v in tree.items()}
    return tree.to(dt) if tree.is_floating_point() else tree


# ------------------------------------------------------ cross entropy ------
def softmax_xent(logits, labels, valid=None):
    """Mean next-token cross entropy. logits (B,S,V) any float; labels (B,S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    # the difference before the select: on vocab-sharded logits the gather
    # is a masked partial sum whose mask has the gather's (B, S, 1) shape
    gold = torch.gather(logits, -1, labels[..., None].long())
    nll = (lse - gold)[..., 0]
    if valid is None:
        return nll.mean()
    w = valid.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
