"""minitron-8b — pruned nemotron [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Nemotron family: squared-ReLU (non-gated) FFN.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    ffn_kind="relu2",
    rope_theta=10_000.0,
    notes="Full attention; long_500k skipped (see DESIGN.md §4).",
)
