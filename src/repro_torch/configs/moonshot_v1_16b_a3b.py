"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — MoE 64e top-6.

48L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=163840.
DeepSeek-V3-style: first layer dense (d_ff 11264), 2 shared experts
[hf:moonshotai/Moonlight-16B-A3B].
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=11264,
    vocab_size=163840,
    moe=MoEConfig(
        n_experts=64,
        experts_per_token=6,
        d_ff_expert=1408,
        n_shared_experts=2,
        d_ff_dense=11264,
        first_k_dense=1,
    ),
    rope_theta=50_000.0,
    notes="Token-choice top-6 routing, capacity-padded grouped experts, EP over model axis.",
)
