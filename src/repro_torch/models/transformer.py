"""Dense decoder-only transformer (qwen2/2.5/3, minitron) and the
prefix-LM VLM variant (paligemma: stubbed SigLIP patch embeddings + gemma
text backbone).

Every model has the reference's API as plain functions on tensors over a
nested dict of parameters: ``param_decls`` / ``cache_decls`` / ``loss`` /
``prefill(params, batch, capacity)`` / ``decode(params, cache, token,
pos)``. Layer stacks are a loop over the stacked layer axis (the
reference's ``lax.scan``), each stacked leaf unbound once per call, with
optional per-layer activation checkpointing (``_maybe_remat``). ``decode``
writes the cache in place and returns it (the reference's serving step
donates it); ``pos`` is a Python int.

The reference casts the layer parameters to ``cfg.dtype`` inside every
call; so does the port (a no-op on a leaf already of that type), and
``serving_params`` casts them once at load, which gives the same values.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import blocks
from repro_torch.models.layers import cast_tree, ffn_apply, softmax_xent


def tree_unbind(tree) -> list:
    """The per-layer trees of a tree of stacked leaves: every leaf unbound
    along its leading (layer) axis once. Indexing one layer at a time
    (``leaf[i]``) would cost, in backward, one zero tensor the size of the
    whole stack per layer; the views of one ``unbind`` stack their
    gradients once."""
    if isinstance(tree, dict):
        keys = list(tree)
        cols = [tree_unbind(tree[k]) for k in keys]
        return [dict(zip(keys, row)) for row in zip(*cols)]
    if isinstance(tree, tuple):
        return [tuple(row) for row in zip(*(tree_unbind(v) for v in tree))]
    return list(torch.unbind(tree, 0))


def tree_stack(trees: list):
    """Stack a list of same-shaped (nested) tuples of tensors along a new
    leading axis."""
    if isinstance(trees[0], tuple):
        return tuple(tree_stack(list(t)) for t in zip(*trees))
    return torch.stack(trees)


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_requires_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def _dots_saveable(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of the matrix products,
    recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` under per-call activation checkpointing when ``cfg.remat``
    (the reference's ``jax.checkpoint``). ``cfg.remat_policy`` "nothing"
    keeps only the inputs and recomputes the body in backward; "dots" also
    keeps the matrix products' outputs. A call that records no gradient
    runs ``fn`` as it is: checkpointing changes what backward keeps, never
    the values."""
    if not cfg.remat:
        return fn
    context_fn = (partial(create_selective_checkpoint_contexts, _dots_saveable)
                  if cfg.remat_policy == "dots" else noop_context_fn)

    def remat(*args):
        if not (torch.is_grad_enabled() and _requires_grad(args)):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return remat


def maybe_scan(body, carry, xs, collect: bool = True):
    """The reference's scan over stacked layer params, as a loop over the
    leading axis: ``body(carry, xs[i]) -> (carry, y)``; the ys stacked."""
    ys = []
    for x in tree_unbind(xs):
        carry, y = body(carry, x)
        ys.append(y)
    if not collect or all(y is None for y in ys):
        return carry, None
    return carry, tree_stack(ys)


def spec(shape, dtype=torch.int32) -> torch.Tensor:
    """A storage-free (``meta``) stand-in for an input of ``shape``."""
    return torch.empty(shape, dtype=dtype, device="meta")


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

        body = _maybe_remat(body, cfg)
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

    # ------------------------------------------------------- input specs ---
    def input_specs(self, shape: ShapeSpec) -> dict:
        """The step's inputs as ``meta`` tensors of the reference's shapes
        and dtypes (decode's ``pos`` is a () int32, the reference's traced
        scalar; the port's ``decode`` takes it as a Python int)."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            return {"tokens": spec((B, S)), "labels": spec((B, S))}
        if shape.kind == "prefill":
            return {"tokens": spec((B, S))}
        # decode: one new token against a cache of S
        return {"token": spec((B, 1)), "pos": spec(())}

    def input_logical(self, shape: ShapeSpec) -> dict:
        """Logical axes for input arrays (resolved by runtime.sharding)."""
        if shape.kind == "train":
            return {"tokens": ("batch", None), "labels": ("batch", None)}
        if shape.kind == "prefill":
            return {"tokens": ("batch", None)}
        return {"token": ("batch", None), "pos": ()}


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

    def input_specs(self, shape: ShapeSpec) -> dict:
        """Text length is seq_len - n_patches, so the attended sequence is
        exactly the assigned shape."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        P = cfg.vlm.n_patches
        T = S - P
        patches = spec((B, P, cfg.d_model), torch.float32)
        if shape.kind == "train":
            return {"tokens": spec((B, T)), "labels": spec((B, T)),
                    "patches": patches}
        if shape.kind == "prefill":
            return {"tokens": spec((B, T)), "patches": patches}
        return {"token": spec((B, 1)), "pos": spec(())}

    def input_logical(self, shape: ShapeSpec) -> dict:
        out = super().input_logical(shape)
        if shape.kind in ("train", "prefill"):
            out["patches"] = ("batch", None, None)
        return out
