"""Config registry: ``get_config(name)`` / ``list_archs()`` /
``smoke_config(name)``, the reference's, over the port's copies of the
family configs (same names, same fields, same reduced dimensions).

``--arch <id>`` in ``serve --mode lm`` resolves through here.
"""
from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES  # noqa: F401

_MODULES = {
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
}


def list_archs():
    return sorted(_MODULES)


def get_config(name: str) -> ArchConfig:
    import importlib

    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_nerf_config(variant: str = "full"):
    """The paper's NeRF config: "full" (``NerfConfig()``), else ``tiny()``."""
    from repro_torch.configs import nerf_icarus

    return nerf_icarus.CONFIG if variant == "full" else nerf_icarus.tiny()


# ---- reduced configs for per-arch smoke tests (same family, tiny dims) ----
def smoke_config(name: str) -> ArchConfig:
    cfg = get_config(name)
    small = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2),
                 head_dim=16, d_ff=128, vocab_size=512, dtype="float32",
                 param_dtype="float32", attn_chunk=32, scan_layers=True, remat=False)
    if cfg.family == "moe":
        # capacity_factor 8: drop-free routing so prefill/decode consistency
        # is exact (capacity-drop behaviour is tested separately)
        small["moe"] = cfg.moe.__class__(
            n_experts=8, experts_per_token=2, d_ff_expert=32,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            d_ff_dense=128, first_k_dense=cfg.moe.first_k_dense,
            capacity_factor=8.0)
        small["d_ff"] = 128
    if cfg.family == "ssm":
        small.update(n_heads=4, n_kv_heads=4, head_dim=16, d_ff=0)
        small["ssm"] = cfg.ssm.__class__(d_state=16, head_dim=16, expand=2,
                                         chunk=16, n_groups=1)
    if cfg.family == "hybrid":
        small["hybrid"] = cfg.hybrid.__class__(pattern=cfg.hybrid.pattern,
                                               window=32, lru_width=64)
        small["n_layers"] = 3  # one full (rec, rec, attn) group
    if cfg.family == "encdec":
        small["encdec"] = cfg.encdec.__class__(n_enc_layers=2, enc_seq=16)
    if cfg.family == "vlm":
        small["vlm"] = cfg.vlm.__class__(n_patches=8)
    return cfg.replace(**small)
