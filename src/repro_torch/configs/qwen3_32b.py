"""qwen3-32b — dense, qk_norm, GQA [hf:Qwen/Qwen3 family].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, head_dim=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,        # qwen3 fixes head_dim=128 (q_dim 8192 != d_model)
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    notes="Full attention; long_500k skipped (see DESIGN.md §4).",
)
