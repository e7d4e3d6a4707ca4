"""whisper-large-v3 — encoder-decoder backbone [arXiv:2212.04356].

32L (decoder) d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866.
Conv audio frontend is a STUB: input_specs() supplies precomputed
(batch, 1500, d_model) frame embeddings (30 s of audio post-conv).
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    ffn_kind="gelu",
    norm_kind="layer",
    tie_embeddings=True,
    encdec=EncDecConfig(n_enc_layers=32, enc_seq=1500),
    rope_theta=0.0,  # learned absolute positions, no RoPE
    notes="Enc-dec; decoder cross-attends 1500 frames. long_500k skipped (full attention).",
)
