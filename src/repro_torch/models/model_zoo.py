"""Unified model construction: ``build_model(cfg)`` returns a model object
with the common API used by the launcher and the tests:

    param_decls() / cache_decls(batch, capacity)   -> Decl trees
    serving_params(params)                         -> params cast once
    loss(params, batch)                            -> scalar
    prefill(params, batch, capacity)               -> (cache, last_logits)
    decode(params, cache, token, pos)              -> (cache, logits)
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.moe import MoELM
from repro_torch.models.rglru import RecurrentLM
from repro_torch.models.ssm import MambaLM
from repro_torch.models.transformer import DenseLM, VLM

_FAMILIES = {
    "dense": DenseLM,
    "moe": MoELM,
    "ssm": MambaLM,
    "hybrid": RecurrentLM,
    "encdec": EncDecLM,
    "vlm": VLM,
}


def build_model(cfg: ArchConfig):
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r} for arch {cfg.name!r}")
    return cls(cfg)
