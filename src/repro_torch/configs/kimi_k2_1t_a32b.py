"""kimi-k2-1t-a32b — trillion-parameter MoE, 384e top-8 [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840.
First layer dense (d_ff 18432), 1 shared expert (per the public K2 config).
Adam moments quantized to int8 (framework feature) so the optimizer state for
1T params fits a 512-chip footprint; see EXPERIMENTS.md §Dry-run.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,        # d_model / n_heads per the assigned table (paper-table tier)
    d_ff=18432,
    vocab_size=163840,
    moe=MoEConfig(
        n_experts=384,
        experts_per_token=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        d_ff_dense=18432,
        first_k_dense=1,
    ),
    rope_theta=50_000.0,
    moment_dtype="int8",
    notes="1T total / ~32B active. EP over model axis (384/16=24 experts per device).",
)
