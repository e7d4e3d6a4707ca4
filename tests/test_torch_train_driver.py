"""The port's LM training driver (``repro_torch.launch.train.run`` with
``--device cpu``) held to ``tests/test_train_driver.py``'s five behaviours
at the reference's own bounds, and to the reference's checkpoint format.

The reference's driver is red under this jax (its explicit-sharding mesh)
except ``--compress``. Whether a 6-step run's last loss lies below its
first is decided by batch noise at this size: over seeds 0 to 9 the
reference's ``--compress`` run falls on 7, the port's on 6 (its stream
draws from a ``torch.Generator``, not ``jax.random``). So the two "loss
falls" tests run the port's driver on the reference's own token batches
(``synthetic_batch`` replaced by the reference's) from the reference's
own initial weights (a step-0 checkpoint the reference's ``Checkpointer``
wrote), where the reference's run falls; with ``--compress`` the port's
first and last losses equal the reference driver's at rtol 1e-4. The
other tests run the port's own stream and weights.
"""
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as JaxCheckpointer
from repro.configs import smoke_config as jax_smoke_config
from repro.data import tokens as jtokens
from repro.launch import steps as jsteps
from repro.launch.train import build_parser as jax_parser, run as jax_run
from repro.models.model_zoo import build_model as jax_build
from repro.models.params import init_params as jax_init
from repro.optim.adam import AdamConfig as JAdamConfig, opt_state_decls

from _torch_lm_common import as_np, leaves_with_path, one_torch_thread  # noqa: F401
from repro_torch.checkpoint import Checkpointer
from repro_torch.launch import train
from repro_torch.launch.train import build_parser, run


def _argv(**kw):
    base = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "8",
            "--batch", "4", "--seq", "32", "--log-every", "100"]
    for k, v in kw.items():
        base += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return base


def _args(**kw):
    return build_parser().parse_args(_argv(**kw) + ["--device", "cpu"])


def _reference_start(directory: str, arch: str = "qwen2-1.5b", seed: int = 0,
                     compress: bool = False):
    """The reference driver's initial state (params from PRNGKey(seed),
    zero moments), saved at step 0 by the reference's Checkpointer."""
    cfg = jax_smoke_config(arch)
    m = jax_build(cfg)
    params = jax_init(m.param_decls(), jax.random.PRNGKey(seed),
                      cfg.param_dtype)
    opt = jax_init(opt_state_decls(m.param_decls(),
                                   JAdamConfig(moment_dtype=cfg.moment_dtype)),
                   jax.random.PRNGKey(0), "float32")
    if compress:
        opt["err"] = jsteps.init_error_state_global(params, 1)
    ck = JaxCheckpointer(directory)
    ck.save(0, {"params": params, "opt": opt},
            {"train_step": 0, "arch": arch, "losses_tail": []})
    ck.wait()
    return {"params": params, "opt": opt}


def _reference_batches(monkeypatch):
    """The driver's token batches replaced by the reference's stream."""
    def batch(cfg, step, b, s, host_id=0, n_hosts=1):
        out = jtokens.synthetic_batch(
            jtokens.TokenStreamConfig(cfg.vocab_size, cfg.branch, cfg.seed),
            step, b, s, host_id, n_hosts)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    monkeypatch.setattr(train, "synthetic_batch", batch)


def test_restart_reproduces_uninterrupted_run():
    """train(12) == train(8) + restart-to-12, to float tolerance: the
    checkpoint carries optimizer + data state exactly."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        full = run(_args(steps=12, ckpt_dir=d1, ckpt_every=100))
        # same schedule (--steps 12), killed at step 8
        run(_args(steps=12, stop_after=8, ckpt_dir=d2, ckpt_every=8))
        resumed = run(_args(steps=12, ckpt_dir=d2, ckpt_every=100))
    assert resumed["steps"] == 4
    np.testing.assert_allclose(full["final_loss"], resumed["final_loss"],
                               rtol=1e-4)


def test_grad_accum_matches_large_batch_direction(monkeypatch, tmp_path):
    _reference_batches(monkeypatch)
    _reference_start(str(tmp_path))
    out = run(_args(steps=6, grad_accum=2, ckpt_dir=tmp_path))
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < out["loss_first"]


def test_compressed_training_single_device(monkeypatch, tmp_path):
    """The port's --compress run on the reference's batches and weights
    against the reference's own --compress run (its live driver path)."""
    _reference_batches(monkeypatch)
    _reference_start(str(tmp_path), compress=True)
    out = run(_args(steps=6, compress=True, ckpt_dir=tmp_path))
    ref = jax_run(jax_parser().parse_args(_argv(steps=6, compress=True)))
    print(f"--compress, first and last loss: port {out['loss_first']}, "
          f"{out['final_loss']}; reference {ref['loss_first']}, "
          f"{ref['final_loss']}")
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < out["loss_first"]
    np.testing.assert_allclose([out["loss_first"], out["final_loss"]],
                               [ref["loss_first"], ref["final_loss"]],
                               rtol=1e-4)


def test_qat_training_runs():
    out = run(_args(steps=6, qat=True))
    assert np.isfinite(out["final_loss"])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "moonshot-v1-16b-a3b",
                                  "whisper-large-v3", "paligemma-3b",
                                  "kimi-k2-1t-a32b"])
def test_driver_covers_every_family(arch):
    out = run(_args(arch=arch, steps=4))
    assert np.isfinite(out["final_loss"])


def test_restores_reference_checkpoint_bit_for_bit(tmp_path):
    """A reference-written checkpoint (int8 moments: kimi-k2's smoke
    config, and the compressed step's residuals) restores bit for bit,
    and the driver resumes from it at its step."""
    state = _reference_start(str(tmp_path), "kimi-k2-1t-a32b", compress=True)
    got, meta = Checkpointer(str(tmp_path)).restore(device="cpu")
    assert meta["train_step"] == 0
    want = dict(leaves_with_path(state))
    assert sorted(want) == sorted(k for k, _ in leaves_with_path(got))
    for k, t in leaves_with_path(got):
        w = as_np(want[k])
        assert t.numpy().dtype == w.dtype and t.shape == w.shape, k
        np.testing.assert_array_equal(t.numpy(), w, err_msg=k)
    out = run(_args(arch="kimi-k2-1t-a32b", steps=3, compress=True,
                    ckpt_dir=tmp_path))
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])


def test_model_axis_needs_a_mesh():
    with pytest.raises(ValueError, match="mesh"):
        run(_args(model_axis=2))


def test_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="card"):
        run(build_parser().parse_args(_argv(steps=1)))
