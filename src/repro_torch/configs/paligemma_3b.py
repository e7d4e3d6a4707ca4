"""paligemma-3b — SigLIP + gemma backbone [arXiv:2407.07726].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.
SigLIP vision tower is a STUB: input_specs() supplies precomputed
(batch, 256, d_model) patch embeddings; prefix-LM mask (bidirectional
prefix over image tokens, causal over text).
"""
from repro_torch.configs.base import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    ffn_kind="geglu",
    vlm=VLMConfig(n_patches=256),
    tie_embeddings=True,
    rope_theta=10_000.0,
    notes="Gemma-2b text backbone; long_500k skipped (full attention).",
)
