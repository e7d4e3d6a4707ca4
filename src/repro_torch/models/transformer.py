"""Dense decoder-only transformer (qwen2/2.5/3, minitron) and the
prefix-LM VLM variant (paligemma: stubbed SigLIP patch embeddings + gemma
text backbone).

Every model has the reference's API as plain functions on tensors over a
nested dict of parameters: ``param_decls`` / ``cache_decls`` / ``loss`` /
``prefill(params, batch, capacity)`` / ``decode(params, cache, token,
pos)``. Layer stacks are a loop over the stacked layer axis (the
reference's ``lax.scan``). ``decode`` writes the cache in place and returns
it (the reference's serving step donates it); ``pos`` is a Python int.

The reference casts the layer parameters to ``cfg.dtype`` inside every
call; so does the port (a no-op on a leaf already of that type), and
``serving_params`` casts them once at load, which gives the same values.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.models.layers import cast_tree, ffn_apply, softmax_xent


def tree_index(tree, i: int):
    """Slice ``i`` of every leaf's leading (layer) axis."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_index(v, i) for v in tree)
    return tree[i]


def tree_stack(trees: list):
    """Stack a list of same-shaped (nested) tuples of tensors along a new
    leading axis."""
    if isinstance(trees[0], tuple):
        return tuple(tree_stack(list(t)) for t in zip(*trees))
    return torch.stack(trees)


def _first_leaf(tree):
    while isinstance(tree, (dict, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def maybe_scan(body, carry, xs, collect: bool = True):
    """The reference's scan over stacked layer params, as a loop over the
    leading axis: ``body(carry, xs[i]) -> (carry, y)``; the ys stacked."""
    ys = []
    for i in range(_first_leaf(xs).shape[0]):
        carry, y = body(carry, tree_index(xs, i))
        ys.append(y)
    if not collect or all(y is None for y in ys):
        return carry, None
    return carry, tree_stack(ys)


def _pad_cache_seq(cache, capacity: int, axis: int):
    """Right-pad every cache leaf to ``capacity`` along the seq axis."""
    def one(t):
        cur = t.shape[axis]
        if cur >= capacity:
            return t
        pads = [0, 0] * (t.ndim - axis - 1) + [0, capacity - cur]
        return F.pad(t, pads)
    return {k: one(v) for k, v in cache.items()}


class DenseLM:
    """Unified model API: param_decls / cache_decls / loss / prefill / decode."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # ------------------------------------------------------------ decls ----
    def layer_decls(self) -> dict:
        cfg = self.cfg
        L = cfg.n_layers
        return {
            "attn_norm": blocks.norm_decls(cfg, L),
            "attn": blocks.attn_decls(cfg, L),
            "ffn_norm": blocks.norm_decls(cfg, L),
            "ffn": blocks.ffn_decls(cfg, L),
        }

    def param_decls(self) -> dict:
        return {**blocks.embed_decls(self.cfg), "layers": self.layer_decls()}

    def cache_decls(self, batch: int, capacity: int) -> dict:
        return blocks.kv_cache_decls(self.cfg, self.cfg.n_layers, batch, capacity)

    def serving_params(self, params: dict) -> dict:
        """``params`` with every leaf that prefill and decode cast to
        ``cfg.dtype`` cast once: all but the final norms (read in f32)."""
        return {k: v if k.endswith("final_norm") else cast_tree(v, self.cfg.dtype)
                for k, v in params.items()}

    # ------------------------------------------------------------ decode pos
    def prefix_len(self) -> int:
        return 0

    # ------------------------------------------------------------ stacks ---
    def _layer_fwd(self, x, lp, pos, collect_kv: bool):
        cfg = self.cfg
        h = blocks.norm_apply(cfg, lp["attn_norm"], x)
        kind = "prefix" if self.prefix_len() else "causal"
        o, k, v = blocks.attn_apply(cfg, lp["attn"], h, pos=pos, kind=kind,
                                    prefix_len=self.prefix_len())
        x = x + o
        h = blocks.norm_apply(cfg, lp["ffn_norm"], x)
        x = x + ffn_apply(h, lp["ffn"], cfg.ffn_kind)
        ys = (k.to(torch.bfloat16), v.to(torch.bfloat16)) if collect_kv else None
        return x, ys

    def backbone(self, params, x, pos, collect_kv: bool = False):
        cfg = self.cfg
        lp_all = cast_tree(params["layers"], cfg.dtype)

        def body(carry, lp):
            return self._layer_fwd(carry, lp, pos, collect_kv)

        x, kv = maybe_scan(body, x, lp_all, collect=collect_kv)
        x = blocks.norm_apply(cfg, params["final_norm"], x)
        return x, kv

    # ---------------------------------------------------------- embedding --
    def embed_inputs(self, params, batch):
        """Returns (x, pos, text_offset). Overridden by the VLM variant."""
        tokens = batch["tokens"]
        x = blocks.embed_tokens(params, tokens, self.cfg.dtype)
        pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                           device=tokens.device)
        return x, pos, 0

    # --------------------------------------------------------------- loss --
    def loss(self, params, batch):
        cfg = self.cfg
        x, pos, off = self.embed_inputs(params, batch)
        x, _ = self.backbone(params, x, pos)
        if off:
            x = x[:, off:]
        logits = blocks.logits_out(cfg, params, x)
        return softmax_xent(logits, batch["labels"])

    # ------------------------------------------------------------ prefill --
    def prefill(self, params, batch, capacity: Optional[int] = None):
        """capacity: total KV slots to allocate (>= attended length +
        tokens to decode). Without it the cache is exactly prompt-sized
        and the first decode write clamps to the last slot (as
        ``dynamic_update_slice`` clamps), so serving must pass it."""
        cfg = self.cfg
        x, pos, _ = self.embed_inputs(params, batch)
        x, kv = self.backbone(params, x, pos, collect_kv=True)
        logits = blocks.logits_out(cfg, params, x[:, -1:])
        cache = {"k": kv[0], "v": kv[1]}
        if capacity is not None:
            cache = _pad_cache_seq(cache, capacity, axis=2)
        return cache, logits

    # ------------------------------------------------------------- decode --
    def decode(self, params, cache, token, pos: int):
        """token: (B,1) int; pos: number of TEXT tokens already cached (the
        prefix offset, patches for the VLM, is added here)."""
        cfg = self.cfg
        pos = int(pos) + self.prefix_len()  # absolute position in attended seq
        x = blocks.embed_tokens(params, token, cfg.dtype)
        lp_all = cast_tree(params["layers"], cfg.dtype)
        kind = "prefix" if self.prefix_len() else "causal"

        def body(x, xs):
            lp, ck, cv = xs
            h = blocks.norm_apply(cfg, lp["attn_norm"], x)
            o, _, _ = blocks.attn_decode(cfg, lp["attn"], h, ck, cv, pos,
                                         kind=kind, prefix_len=self.prefix_len())
            x = x + o
            h = blocks.norm_apply(cfg, lp["ffn_norm"], x)
            return x + ffn_apply(h, lp["ffn"], cfg.ffn_kind), None

        x, _ = maybe_scan(body, x, (lp_all, cache["k"], cache["v"]),
                          collect=False)
        x = blocks.norm_apply(cfg, params["final_norm"], x)
        return cache, blocks.logits_out(cfg, params, x)


class VLM(DenseLM):
    """paligemma: [patch embeddings | text] with a prefix-LM mask.

    The SigLIP tower is a stub, as in the reference: the batch supplies
    precomputed (B, n_patches, d_model) patch embeddings.
    """

    def prefix_len(self) -> int:
        return self.cfg.vlm.n_patches

    def embed_inputs(self, params, batch):
        cfg = self.cfg
        tok = blocks.embed_tokens(params, batch["tokens"], cfg.dtype)
        patches = batch["patches"].to(getattr(torch, cfg.dtype))
        x = torch.cat([patches, tok], dim=1)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        return x, pos, cfg.vlm.n_patches
