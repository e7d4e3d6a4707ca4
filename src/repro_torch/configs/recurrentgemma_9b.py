"""recurrentgemma-9b — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427 Griffin].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window=2048.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    ffn_kind="geglu",
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), window=2048, lru_width=4096),
    tie_embeddings=True,
    supports_long=True,  # RG-LRU state + bounded-window KV => O(1)-ish decode state
    notes="Local attention window 2048; RG-LRU via associative scan.",
)
