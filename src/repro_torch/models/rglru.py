"""recurrentgemma — Griffin-style hybrid: RG-LRU recurrent blocks + local
sliding-window MQA attention in a (rec, rec, attn) pattern [arXiv:2402.19427].

The linear recurrence h_t = a_t*h_{t-1} + b_t runs as the reference's
associative scan (the same odd/even recursion, so the same roundings) for
prefill and as O(1) state for decode; the attention cache is a
window-sized ring buffer.

Simplification vs. the released model (the reference's): the RG-LRU
recurrence/input gates use diagonal (per-channel) weights rather than
block-diagonal linear maps.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (cast_tree, ffn_apply, gelu_tanh, sigmoid,
                                       softplus)
from repro_torch.models.params import Decl
from repro_torch.models.ssm import _causal_conv, _conv_step
from repro_torch.models.transformer import DenseLM, _maybe_remat, maybe_scan

_C = 8.0  # RG-LRU temperature


def _assoc_scan(a, b):
    """``lax.associative_scan`` of (a, b) under (l, r) -> (l.a * r.a,
    l.b * r.a + r.b) along axis 1: the reference's recursion, pairs
    combined, the odd positions scanned, the even ones filled in."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = a[:, 0:n - 1:2] * a[:, 1::2], b[:, 0:n - 1:2] * a[:, 1::2] + b[:, 1::2]
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        la, lb = oa[:, :-1], ob[:, :-1]
    else:
        la, lb = oa, ob
    ea = torch.cat([a[:, :1], la * a[:, 2::2]], dim=1)
    eb = torch.cat([b[:, :1], lb * a[:, 2::2] + b[:, 2::2]], dim=1)
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = ea, oa
    out_b[:, 0::2], out_b[:, 1::2] = eb, ob
    return out_a, out_b


def _lru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t over axis 1. a,b: (B,S,W) fp32."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    return _assoc_scan(a, b)[1]


class RecurrentLM(DenseLM):
    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        h = cfg.hybrid
        self.w = h.lru_width or cfg.d_model
        self.pattern = h.pattern
        per = len(h.pattern)
        self.n_groups_scan = cfg.n_layers // per
        self.tail_kinds = tuple(h.pattern[i % per]
                                for i in range(self.n_groups_scan * per, cfg.n_layers))
        self.n_rec = sum(1 for i in range(cfg.n_layers)
                         if h.pattern[i % per] == "rec")
        self.n_attn = cfg.n_layers - self.n_rec

    # ------------------------------------------------------------ decls ----
    def _rec_decls(self, L: int) -> dict:
        cfg = self.cfg
        d, w = cfg.d_model, self.w
        cw = cfg.hybrid.conv_width
        lead = (L,) if L else ()
        ll = ("layers",) if L else ()
        return {
            "norm": blocks.norm_decls(cfg, L),
            "w_gate": Decl(lead + (d, w), ll + ("embed", "lru")),
            "w_x": Decl(lead + (d, w), ll + ("embed", "lru")),
            "w_out": Decl(lead + (w, d), ll + ("lru", "embed")),
            "conv": Decl(lead + (cw, w), ll + (None, "lru"), init="small"),
            "lam": Decl(lead + (w,), ll + ("lru",), init="small"),
            "wa": Decl(lead + (w,), ll + ("lru",), init="small"),
            "ba": Decl(lead + (w,), ll + ("lru",), init="zeros"),
            "wi": Decl(lead + (w,), ll + ("lru",), init="small"),
            "bi": Decl(lead + (w,), ll + ("lru",), init="zeros"),
        }

    def _attn_decls(self, L: int) -> dict:
        return {"norm": blocks.norm_decls(self.cfg, L),
                "attn": blocks.attn_decls(self.cfg, L)}

    def _ffn_decls(self, L: int) -> dict:
        return {"norm": blocks.norm_decls(self.cfg, L),
                "ffn": blocks.ffn_decls(self.cfg, L)}

    def param_decls(self) -> dict:
        G = self.n_groups_scan
        group = {}
        for j, kind in enumerate(self.pattern):
            group[f"mix{j}"] = self._rec_decls(G) if kind == "rec" \
                else self._attn_decls(G)
            group[f"ffn{j}"] = self._ffn_decls(G)
        tail = {}
        for j, kind in enumerate(self.tail_kinds):
            tail[f"mix{j}"] = self._rec_decls(0) if kind == "rec" \
                else self._attn_decls(0)
            tail[f"ffn{j}"] = self._ffn_decls(0)
        out = {**blocks.embed_decls(self.cfg), "groups": group}
        if tail:
            out["tail"] = tail
        return out

    def cache_decls(self, batch: int, capacity: int) -> dict:
        cfg = self.cfg
        W = cfg.hybrid.window   # ring buffer: always window-sized
        cw = cfg.hybrid.conv_width
        kv = (self.n_attn, batch, W, cfg.n_kv_heads, cfg.head_dim)
        kv_logical = ("layers", "batch", "seq", "kvheads", "headdim_tp")
        return {
            "k": Decl(kv, kv_logical, init="zeros", dtype="bfloat16"),
            "v": Decl(kv, kv_logical, init="zeros", dtype="bfloat16"),
            "h": Decl((self.n_rec, batch, self.w), ("layers", "batch", "lru"),
                      init="zeros", dtype="float32"),
            "conv": Decl((self.n_rec, batch, cw - 1, self.w),
                         ("layers", "batch", None, "lru"),
                         init="zeros", dtype="float32"),
        }

    # ----------------------------------------------------------- blocks ----
    def _gates(self, lp, u):
        """(a, sqrt(1 - a^2) * i * u) of the RG-LRU at conv output u (f32)."""
        r = sigmoid(u * lp["wa"] + lp["ba"])
        i = sigmoid(u * lp["wi"] + lp["bi"])
        a = torch.exp(-_C * softplus(lp["lam"].float()) * r)
        return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u)

    def _rec_fwd(self, lp, x, h0=None):
        """Full-sequence recurrent block. Returns (out, h_last, conv_tail)."""
        cfg = self.cfg
        h = blocks.norm_apply(cfg, lp["norm"], x)
        gate = gelu_tanh(h @ lp["w_gate"])
        u_raw = h @ lp["w_x"]
        u = _causal_conv(u_raw.float(), lp["conv"].float())
        a, b = self._gates(lp, u)
        hs = _lru_scan(a, b, h0)
        y = (gate * hs.to(gate.dtype)) @ lp["w_out"]
        cw = cfg.hybrid.conv_width
        return x + y, hs[:, -1], u_raw[:, -(cw - 1):].float()

    def _rec_step(self, lp, x, h_prev, ring):
        """One-token recurrent block. x: (B,1,d); h_prev and ring written
        in place."""
        cfg = self.cfg
        h = blocks.norm_apply(cfg, lp["norm"], x)
        gate = gelu_tanh(h @ lp["w_gate"])
        u_raw = (h @ lp["w_x"]).float()
        ring_new, u = _conv_step(ring, u_raw, lp["conv"].float())
        a, b = self._gates(lp, u[:, 0])
        h_new = a * h_prev + b
        y = (gate * h_new[:, None].to(gate.dtype)) @ lp["w_out"]
        h_prev.copy_(h_new), ring.copy_(ring_new)
        return x + y

    def _attn_fwd(self, lp, x, pos):
        cfg = self.cfg
        h = blocks.norm_apply(cfg, lp["norm"], x)
        o, k, v = blocks.attn_apply(cfg, lp["attn"], h, pos=pos, kind="local",
                                    window=cfg.hybrid.window)
        return x + o, k, v

    def _ffn_fwd(self, lp, x):
        h = blocks.norm_apply(self.cfg, lp["norm"], x)
        return x + ffn_apply(h, lp["ffn"], self.cfg.ffn_kind)

    # ------------------------------------------------------------- stack ---
    def backbone(self, params, x, pos, collect_kv: bool = False):
        cfg = self.cfg
        W = cfg.hybrid.window

        def to_ring(t):
            """Linear (B,S,...) -> ring layout (B,W,...): position p at slot
            p % W, zeros in never-written slots — exactly the layout
            attn_decode(ring=True) assumes, so decode continues seamlessly."""
            B, S = t.shape[:2]
            L = min(S, W)
            ring = torch.zeros((B, W) + t.shape[2:], dtype=torch.bfloat16,
                               device=t.device)
            slots = torch.arange(S - L, S, device=t.device) % W
            ring[:, slots] = t[:, -L:].to(torch.bfloat16)
            return ring

        def body(x, gp):
            recs, attns = [], []
            for j, kind in enumerate(self.pattern):
                lp = gp[f"mix{j}"]
                if kind == "rec":
                    x, h_last, tail = self._rec_fwd(lp, x)
                    recs.append((h_last, tail))
                else:
                    x, k, v = self._attn_fwd(lp, x, pos)
                    attns.append((to_ring(k), to_ring(v)))
                x = self._ffn_fwd(gp[f"ffn{j}"], x)
            if not collect_kv:
                return x, None
            stack = lambda ps: tuple(torch.stack(t) for t in zip(*ps))
            return x, (stack(recs), stack(attns))

        body = _maybe_remat(body, cfg)
        x, ys = maybe_scan(body, x, cast_tree(params["groups"], cfg.dtype),
                           collect=collect_kv)

        tails = []
        if "tail" in params:
            tp_all = cast_tree(params["tail"], cfg.dtype)
            for j, kind in enumerate(self.tail_kinds):
                lp = tp_all[f"mix{j}"]
                if kind == "rec":
                    x, h_last, tail = self._rec_fwd(lp, x)
                    tails.append((h_last, tail))
                else:
                    x, _, _ = self._attn_fwd(lp, x, pos)
                x = self._ffn_fwd(tp_all[f"ffn{j}"], x)

        x = blocks.norm_apply(cfg, params["final_norm"], x)
        if not collect_kv:
            return x, None

        # assemble cache: the loop's ys are (G, per_group, ...) -> flatten
        (h_g, conv_g), (k_g, v_g) = ys
        flat = lambda t: t.reshape((-1,) + t.shape[2:])
        hs, convs = flat(h_g), flat(conv_g)
        if tails:
            hs = torch.cat([hs, torch.stack([t[0] for t in tails])])
            convs = torch.cat([convs, torch.stack([t[1] for t in tails])])
        return x, {"k": flat(k_g), "v": flat(v_g), "h": hs, "conv": convs}

    def prefill(self, params, batch, capacity=None):
        """capacity ignored: KV is a window-sized ring; rec state is O(1)."""
        x, pos, _ = self.embed_inputs(params, batch)
        x, cache = self.backbone(params, x, pos, collect_kv=True)
        return cache, blocks.logits_out(self.cfg, params, x[:, -1:])

    def decode(self, params, cache, token, pos: int):
        cfg = self.cfg
        pos = int(pos)
        x = blocks.embed_tokens(params, token, cfg.dtype)
        W = cfg.hybrid.window
        rec_per = sum(1 for k in self.pattern if k == "rec")
        att_per = len(self.pattern) - rec_per
        G = self.n_groups_scan

        def body(x, xs):
            gp, hs, convs, ks, vs = xs     # per-group cache slices
            ri = ai = 0
            for j, kind in enumerate(self.pattern):
                lp = gp[f"mix{j}"]
                if kind == "rec":
                    x = self._rec_step(lp, x, hs[ri], convs[ri])
                    ri += 1
                else:
                    hn = blocks.norm_apply(cfg, lp["norm"], x)
                    o, _, _ = blocks.attn_decode(
                        cfg, lp["attn"], hn, ks[ai], vs[ai], pos,
                        kind="local", window=W, ring=True)
                    x = x + o
                    ai += 1
                x = self._ffn_fwd(gp[f"ffn{j}"], x)
            return x, None

        group = lambda t, per: t[:G * per].unflatten(0, (G, per))
        x, _ = maybe_scan(body, x, (cast_tree(params["groups"], cfg.dtype),
                                    group(cache["h"], rec_per),
                                    group(cache["conv"], rec_per),
                                    group(cache["k"], att_per),
                                    group(cache["v"], att_per)),
                          collect=False)

        if "tail" in params:
            tp_all = cast_tree(params["tail"], cfg.dtype)
            ri = G * rec_per
            for j, kind in enumerate(self.tail_kinds):
                if kind == "rec":   # the reference's decode skips a tail attn
                    x = self._rec_step(tp_all[f"mix{j}"], x, cache["h"][ri],
                                       cache["conv"][ri])
                    ri += 1
                x = self._ffn_fwd(tp_all[f"ffn{j}"], x)

        x = blocks.norm_apply(cfg, params["final_norm"], x)
        return cache, blocks.logits_out(cfg, params, x)
