"""The JAX package's training step on the e2e LM example's ~100M config
(``examples/lm_train_e2e.py``: qwen2 family, 10 layers, d_model 512,
vocab 65536, B 16 x S 256, lr 6e-4), mesh-free (the package's driver is
red under jax 0.9.0), on its own weights (``PRNGKey(0)``) and token
stream: the first phase's losses, its 180-step schedule, and the
stream's unigram entropy. The port's curve on the card is
``chip_smoke.py``'s; this is the reference it is read against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_e2e_reference_curve.py [STEPS]

About 13 s per step on 4 CPU cores (~40 min for 180).
"""
import sys
import time

import jax

from repro.configs import get_config
from repro.data.tokens import TokenStreamConfig, synthetic_batch, unigram_entropy
from repro.launch.steps import make_train_step
from repro.models.model_zoo import build_model
from repro.models.params import init_params
from repro.optim.adam import AdamConfig, opt_state_decls


def main(steps: int = 180, total: int = 180):
    cfg = get_config("qwen2-1.5b").replace(
        n_layers=10, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
        d_ff=2048, vocab_size=65536, dtype="float32", param_dtype="float32",
        remat=False, attn_chunk=256)
    model = build_model(cfg)
    opt_cfg = AdamConfig(lr=6e-4, warmup_steps=min(50, total // 10 + 1),
                         total_steps=total, moment_dtype=cfg.moment_dtype)
    decls = model.param_decls()
    params = init_params(decls, jax.random.PRNGKey(0), cfg.param_dtype)
    opt = init_params(opt_state_decls(decls, opt_cfg), jax.random.PRNGKey(0),
                      "float32")
    step = jax.jit(make_train_step(model, opt_cfg), donate_argnums=(0, 1))
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seed=0)
    t0 = time.time()
    for s in range(steps):
        params, opt, m = step(params, opt,
                              dict(synthetic_batch(stream, s, 16, 256)))
        if s % 10 == 0 or s == steps - 1:
            print(s, float(m["loss"]), f"{time.time() - t0:.0f}s", flush=True)
    print("unigram", unigram_entropy(TokenStreamConfig(vocab_size=65536)))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
