"""The bf16-vs-f32 gap of qwen2-1.5b's prefill logits at full width and 2
layers, in the JAX package and in the port, on the same weights.

    PYTHONPATH=src python tests/lm_precision_gap.py [--layers 2] [--seed 0]

The weights are the port's ``init_params`` drawn from
``torch.Generator().manual_seed(seed)`` on the CPU (the draw
``chip_smoke.py``'s precision gate makes), handed to the reference as
numpy; the prompt is 2 x 64 tokens from ``np.random.default_rng(seed)``.
Each package runs the config once with ``dtype="bfloat16"`` and once with
``dtype="float32"``; the gap is the largest |bf16 - f32| of the last
position's logits. The reference runs jitted, as its ``serve --mode lm``
runs it, and op by op (``jax.disable_jit``); the port runs on the CPU.
``chip_smoke.py`` holds the port's gap on the card to twice the jitted
reference's (``LM_REF_BF16_GAP``). Not a test (no ``test_`` prefix): a
measurement that needs both packages, so it lives beside their tests.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model_zoo import build_model as jax_build

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import init_params

B, S = 2, 64


def draw(n_layers: int, seed: int):
    """The port's full-width qwen2-1.5b weights at ``n_layers`` (f32, CPU)
    and the prompt tokens."""
    cfg = get_config("qwen2-1.5b").replace(n_layers=n_layers)
    params = init_params(build_model(cfg).param_decls(),
                         torch.Generator().manual_seed(seed))
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, params, tokens


def port_logits(cfg, params, tokens, dtype: str) -> np.ndarray:
    model = build_model(cfg.replace(dtype=dtype))
    _, logits = model.prefill(model.serving_params(params),
                              {"tokens": torch.from_numpy(tokens)})
    return logits.float().numpy()


def reference_logits(n_layers, np_params, tokens, dtype: str,
                     jit: bool) -> np.ndarray:
    cfg = jax_get_config("qwen2-1.5b").replace(n_layers=n_layers, dtype=dtype)
    model = jax_build(cfg)
    p = jax.tree.map(jnp.asarray, np_params)
    batch = {"tokens": jnp.asarray(tokens)}
    if jit:
        _, logits = jax.jit(model.prefill)(p, batch)
    else:
        with jax.disable_jit():
            _, logits = model.prefill(p, batch)
    return np.asarray(logits, np.float32)


def gaps(n_layers: int = 2, seed: int = 0) -> dict:
    cfg, params, tokens = draw(n_layers, seed)
    np_params = bridge.to_numpy(params)
    gap = lambda a, b: float(np.abs(a - b).max())
    out = {"arch": "qwen2-1.5b", "n_layers": n_layers, "batch": B,
           "prompt_len": S, "seed": seed}
    for label, jit in (("reference_jit", True), ("reference_eager", False)):
        out[label] = gap(*(reference_logits(n_layers, np_params, tokens, dt,
                                            jit)
                           for dt in ("bfloat16", "float32")))
    out["port_cpu"] = gap(*(port_logits(cfg, params, tokens, dt)
                            for dt in ("bfloat16", "float32")))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    print(json.dumps(gaps(a.layers, a.seed)))
