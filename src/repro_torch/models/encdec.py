"""whisper-large-v3 backbone — encoder-decoder transformer
[arXiv:2212.04356]. LayerNorm (pre-LN), GELU FFN, learned absolute
positions, tied output embedding.

The conv audio frontend is a stub, as in the reference: the batch supplies
precomputed (B, enc_seq, d_model) frame embeddings. The encoder, the
decoder with cross-attention and the caches are real. The learned decoder
positions are read with the reference's clamped slice start
(``dynamic_slice_in_dim``), so a position past ``MAX_DEC_POS`` reads the
last row.
"""
from __future__ import annotations

import torch

from repro_torch.models import blocks
from repro_torch.models.layers import (attention, cast_tree, clamped_start,
                                       ffn_apply, softmax_xent)
from repro_torch.models.params import Decl
from repro_torch.models.transformer import (DenseLM, _maybe_remat,
                                            _pad_cache_seq, maybe_scan)

MAX_DEC_POS = 32768  # sized to the largest assigned decode shape


def _dec_pos(params, start: int, size: int, dtype: str):
    table = params["dec_pos"]
    s = clamped_start(start, size, table.shape[0])
    return table[s:s + size].to(getattr(torch, dtype))


class EncDecLM(DenseLM):
    # ------------------------------------------------------------ decls ----
    def param_decls(self) -> dict:
        cfg = self.cfg
        e = cfg.encdec
        d = cfg.d_model
        enc_layer = {
            "attn_norm": blocks.norm_decls(cfg, e.n_enc_layers),
            "attn": blocks.attn_decls(cfg, e.n_enc_layers),
            "ffn_norm": blocks.norm_decls(cfg, e.n_enc_layers),
            "ffn": blocks.ffn_decls(cfg, e.n_enc_layers),
        }
        dec_layer = {
            "attn_norm": blocks.norm_decls(cfg, cfg.n_layers),
            "attn": blocks.attn_decls(cfg, cfg.n_layers),
            "cross_norm": blocks.norm_decls(cfg, cfg.n_layers),
            "cross": blocks.attn_decls(cfg, cfg.n_layers, cross=True),
            "ffn_norm": blocks.norm_decls(cfg, cfg.n_layers),
            "ffn": blocks.ffn_decls(cfg, cfg.n_layers),
        }
        return {
            **blocks.embed_decls(cfg),
            "enc_pos": Decl((e.enc_seq, d), init="small"),
            "dec_pos": Decl((MAX_DEC_POS, d), init="small"),
            "enc_final_norm": blocks.norm_decls(cfg, 0),
            "enc_layers": enc_layer,
            "layers": dec_layer,
        }

    def cache_decls(self, batch: int, capacity: int) -> dict:
        cfg = self.cfg
        self_kv = blocks.kv_cache_decls(cfg, cfg.n_layers, batch, capacity)
        cross = blocks.kv_cache_decls(cfg, cfg.n_layers, batch, cfg.encdec.enc_seq)
        return {"k": self_kv["k"], "v": self_kv["v"],
                "cross_k": cross["k"], "cross_v": cross["v"]}

    # ------------------------------------------------------------ encoder --
    def encode(self, params, frames):
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x = frames.to(dt) + params["enc_pos"].to(dt)
        pos = torch.arange(frames.shape[1], dtype=torch.int32,
                           device=frames.device)

        def body(x, lp):
            h = blocks.norm_apply(cfg, lp["attn_norm"], x)
            o, _, _ = blocks.attn_apply(cfg, lp["attn"], h, pos=pos, kind="full")
            x = x + o
            h = blocks.norm_apply(cfg, lp["ffn_norm"], x)
            return x + ffn_apply(h, lp["ffn"], cfg.ffn_kind), None

        body = _maybe_remat(body, cfg)
        x, _ = maybe_scan(body, x, cast_tree(params["enc_layers"], cfg.dtype),
                          collect=False)
        return blocks.norm_apply(cfg, params["enc_final_norm"], x)

    # ------------------------------------------------------------ decoder --
    def _cross_apply(self, lp, x, enc_out):
        q = blocks.proj_in(x, lp["wq"])
        k = blocks.proj_in(enc_out, lp["wk"])
        v = blocks.proj_in(enc_out, lp["wv"])
        o = attention(q, k, v, q_pos=torch.arange(x.shape[1], dtype=torch.int32,
                                                  device=x.device),
                      kind="full", chunk=self.cfg.attn_chunk)
        return blocks.proj_out(o, lp["wo"]), k, v

    def _decoder(self, params, tokens, enc_out, pos0: int = 0,
                 collect_kv: bool = False):
        cfg = self.cfg
        S = tokens.shape[1]
        pos = torch.arange(S, dtype=torch.int32, device=tokens.device) + pos0
        x = blocks.embed_tokens(params, tokens, cfg.dtype)
        x = x + _dec_pos(params, pos0, S, cfg.dtype)

        def body(x, lp):
            h = blocks.norm_apply(cfg, lp["attn_norm"], x)
            o, k, v = blocks.attn_apply(cfg, lp["attn"], h, pos=pos)
            x = x + o
            h = blocks.norm_apply(cfg, lp["cross_norm"], x)
            o, ck, cv = self._cross_apply(lp["cross"], h, enc_out)
            x = x + o
            h = blocks.norm_apply(cfg, lp["ffn_norm"], x)
            x = x + ffn_apply(h, lp["ffn"], cfg.ffn_kind)
            ys = None
            if collect_kv:
                ys = tuple(t.to(torch.bfloat16) for t in (k, v, ck, cv))
            return x, ys

        body = _maybe_remat(body, cfg)
        x, ys = maybe_scan(body, x, cast_tree(params["layers"], cfg.dtype),
                           collect=collect_kv)
        return blocks.norm_apply(cfg, params["final_norm"], x), ys

    # --------------------------------------------------------------- api ---
    def loss(self, params, batch):
        enc_out = self.encode(params, batch["frames"])
        x, _ = self._decoder(params, batch["tokens"], enc_out)
        logits = blocks.logits_out(self.cfg, params, x)
        return softmax_xent(logits, batch["labels"])

    def prefill(self, params, batch, capacity=None):
        enc_out = self.encode(params, batch["frames"])
        x, ys = self._decoder(params, batch["tokens"], enc_out, collect_kv=True)
        cache = {"k": ys[0], "v": ys[1]}
        if capacity is not None:
            cache = _pad_cache_seq(cache, capacity, axis=2)
        cache.update({"cross_k": ys[2], "cross_v": ys[3]})
        return cache, blocks.logits_out(self.cfg, params, x[:, -1:])

    def decode(self, params, cache, token, pos: int):
        cfg = self.cfg
        pos = int(pos)
        x = blocks.embed_tokens(params, token, cfg.dtype)
        x = x + _dec_pos(params, pos, 1, cfg.dtype)
        q_pos = torch.zeros((1,), dtype=torch.int32, device=x.device)

        def body(x, xs):
            lp, ck, cv, xk, xv = xs
            h = blocks.norm_apply(cfg, lp["attn_norm"], x)
            o, _, _ = blocks.attn_decode(cfg, lp["attn"], h, ck, cv, pos)
            x = x + o
            h = blocks.norm_apply(cfg, lp["cross_norm"], x)
            q = blocks.proj_in(h, lp["cross"]["wq"])
            o = attention(q, xk, xv, q_pos=q_pos, kind="full",
                          chunk=cfg.attn_chunk)
            x = x + blocks.proj_out(o, lp["cross"]["wo"])
            h = blocks.norm_apply(cfg, lp["ffn_norm"], x)
            return x + ffn_apply(h, lp["ffn"], cfg.ffn_kind), None

        x, _ = maybe_scan(body, x, (cast_tree(params["layers"], cfg.dtype),
                                    cache["k"], cache["v"],
                                    cache["cross_k"], cache["cross_v"]),
                          collect=False)
        x = blocks.norm_apply(cfg, params["final_norm"], x)
        return cache, blocks.logits_out(cfg, params, x)
