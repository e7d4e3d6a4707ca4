"""The port's LM train steps against the reference's, for every arch's
smoke config (f32) on the reference's ``init_params(PRNGKey(0))`` weights:
3-step loss trajectories of ``make_train_step`` and of
``make_grad_accum_train_step(n_micro=2)`` on numpy-seeded batches, with
AdamW moments in the arch's ``moment_dtype`` (int8 for kimi-k2), within
rtol 1e-4. Whole steps are compared by their losses, not param by param:
at step 1 AdamW moves each param by about ``lr * sign(g)``, and a
near-zero gradient element whose sign differs between the frameworks
moves its param by 2 lr (``tests/test_torch_lm_train.py`` holds the
gradients and AdamW themselves to the reference).
"""
import jax
import numpy as np
import pytest

from repro.launch import steps as jsteps
from repro.models.params import init_params as jax_init
from repro.optim import adam as ja

from _torch_lm_common import (batch, jax_batch, models, one_torch_thread,  # noqa: F401
                              torch_batch)
from repro_torch import bridge
from repro_torch.configs import list_archs
from repro_torch.launch import steps
from repro_torch.optim import adam as ta

TRAJ_RTOL = 1e-4


@pytest.mark.parametrize("kind", ["plain", "grad_accum"])
@pytest.mark.parametrize("arch", list_archs())
def test_loss_trajectory(arch, kind):
    jm, jp, m, p = models(arch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10,
              moment_dtype=m.cfg.moment_dtype)
    jcfg, tcfg = ja.AdamConfig(**kw), ta.AdamConfig(**kw)
    if kind == "plain":
        jstep = jsteps.make_train_step(jm, jcfg)
        tstep = steps.make_train_step(m, tcfg)
    else:
        jstep = jsteps.make_grad_accum_train_step(jm, jcfg, 2)
        tstep = steps.make_grad_accum_train_step(m, tcfg, 2)
    jstep = jax.jit(jstep)
    jo = jax_init(ja.opt_state_decls(jm.param_decls(), jcfg),
                  jax.random.PRNGKey(0), "float32")
    to = bridge.lm_opt_state_from_numpy(jax.tree.map(np.asarray, jo))
    jl, tl = [], []
    for i in range(3):
        b = batch(m.cfg, 4, 16, seed=i)
        jp, jo, jmet = jstep(jp, jo, jax_batch(b))
        p, to, tmet = tstep(p, to, torch_batch(b))
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    assert int(to["step"]) == 3
    print(f"{arch} {kind}: reference {jl}, port {tl}")
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)
