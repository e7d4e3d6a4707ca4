"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560, attention-free, vocab 50280, ssm_state=128.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,          # d_inner(5120) / head_dim(64)
    n_kv_heads=80,
    head_dim=64,
    d_ff=0,              # attention-free, no separate FFN (Mamba block is the mixer)
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256, n_groups=1),
    tie_embeddings=True,
    supports_long=True,  # SSD decode state is O(1) in sequence length
    notes="SSD chunked dual form for train/prefill; O(1) recurrent state for decode.",
)
