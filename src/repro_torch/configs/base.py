"""Config system: architecture configs + input-shape specs.

Every assigned architecture is a frozen ``ArchConfig``; the four assigned
input shapes are ``ShapeSpec``s. ``(arch, shape)`` pairs form the dry-run /
roofline grid. The NeRF/ICARUS side has its own ``NerfConfig``.

The port's own copy of the reference configuration, field for field, so a
config built on either side describes the same network.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape (seq_len x global_batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_dense: int = 0         # FFN width of the leading dense layers
    first_k_dense: int = 0      # number of leading dense (non-MoE) layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    """mamba2 / SSD block parameters."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    n_groups: int = 1
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """recurrentgemma: RG-LRU + local attention, pattern-interleaved."""

    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    window: int = 2048
    lru_width: int = 0          # 0 => d_model
    conv_width: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    enc_seq: int = 1500         # whisper: 30 s audio -> 1500 frames post-conv
    enc_feature_dim: int = 0    # 0 => d_model (stub supplies embeddings)


@dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256        # paligemma 224px SigLIP-so400m -> 256 tokens
    patch_embed_dim: int = 0    # 0 => d_model (stub supplies projected embeds)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // n_heads
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    logits_softcap: float = 0.0
    # FFN
    ffn_kind: str = "swiglu"    # swiglu | geglu | gelu | relu2
    # norm/embedding
    norm_kind: str = "rms"      # rms | layer (whisper)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # compute policy
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    moment_dtype: str = "float32"   # "int8" => quantized Adam moments
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots (save matmul outputs)
    scan_layers: bool = True
    attn_chunk: int = 1024          # online-softmax KV chunk
    # which assigned shapes are runnable (long_500k only for sub-quadratic)
    supports_long: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.family == "ssm"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def shapes(self) -> Sequence[ShapeSpec]:
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.supports_long:
            out.append(SHAPES["long_500k"])
        return out

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for MODEL_FLOPS = 6*N*D roofline term) ----
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        V = self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                p += self.q_dim + 2 * self.kv_dim
            return p

        def ffn_params(ff: int) -> int:
            mult = 3 if self.ffn_kind in ("swiglu", "geglu") else 2
            return mult * d * ff

        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            # in_proj -> [z, x, B, C, dt], out_proj, conv, A, D, norm
            conv_dim = di + 2 * s.n_groups * s.d_state
            per = (d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                   + di * d + conv_dim * s.conv_width + 2 * nh + di)
            return emb + L * (per + d)
        if self.family == "moe":
            m = self.moe
            dense = attn_params() + ffn_params(m.d_ff_dense or self.d_ff)
            router = d * m.n_experts
            experts = m.n_experts * ffn_params(m.d_ff_expert)
            shared = m.n_shared_experts * ffn_params(m.d_ff_expert)
            moe_layer = attn_params() + router + experts + shared
            total = (emb + m.first_k_dense * dense
                     + (L - m.first_k_dense) * moe_layer + 2 * L * d + d)
            if active_only:
                act_expert = m.experts_per_token * ffn_params(m.d_ff_expert)
                moe_act = attn_params() + router + act_expert + shared
                total = (emb + m.first_k_dense * dense
                         + (L - m.first_k_dense) * moe_act + 2 * L * d + d)
            return total
        if self.family == "hybrid":
            h = self.hybrid
            w = h.lru_width or d
            # rec block: gates+proj (in 2*w, gates 2*w*w/... approx per Griffin)
            rec = d * 2 * w + w * d + 2 * w * w // 8 + h.conv_width * w + w
            attn = attn_params()
            n_rec = sum(1 for i in range(L) if h.pattern[i % len(h.pattern)] == "rec")
            n_att = L - n_rec
            per_ffn = ffn_params(self.d_ff)
            return emb + n_rec * (rec + per_ffn) + n_att * (attn + per_ffn) + 2 * L * d
        if self.family == "encdec":
            e = self.encdec
            enc = e.n_enc_layers * (attn_params() + ffn_params(self.d_ff) + 2 * d)
            dec = L * (2 * attn_params() + ffn_params(self.d_ff) + 3 * d)
            return emb + enc + dec
        # dense / vlm
        per = attn_params() + ffn_params(self.d_ff) + 2 * d
        return emb + L * per + d
