"""int8 gradient compression with error feedback
(``repro_torch.runtime.compression``) and the compressed data-parallel
train step against the reference.

* ``quant_rows``/``dequant_rows`` bit for bit (ties at .5 included: both
  round half to even); the reference's error-feedback, state-shape and
  wire-model tests (``tests/test_runtime.py``) on the port;
* the compressed mean at n = 1 (no process group: the collectives are
  identities) against the reference's ``shard_map`` on its one CPU
  device, fed the reference's gradients: gradients and residuals within
  1e-6; then the whole compressed step on the reference's weights;
* n = 2: two spawned ``gloo`` processes against the reference on 2 fake
  CPU devices (the ``fake_devices`` fixture), the same checks.

Whole steps compare the loss at rtol 1e-5 and the residuals within 1e-6,
except entries whose int8 code differs by one (a rounding tie of
gradients that differ in their last ulps: residuals +s/2 and -s/2),
which are counted and bounded, and params within 1e-6 except the
entries those ties moved.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models.params import init_params as jax_init
from repro.optim import adam as ja
from repro.runtime import compression as jc
from repro.runtime.compat import shard_map

from _torch_lm_common import (as_np, batch, jax_batch, leaves_with_path,  # noqa: F401
                              models, one_torch_thread, torch_batch)
from repro_torch import bridge
from repro_torch.launch import steps
from repro_torch.optim import adam as ta
from repro_torch.runtime import compression as tc

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
ARCH = "qwen2-1.5b"


def test_quant_rows_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    # rows whose scale is exactly 1 with values on .5: ties round to even
    x[0] = np.linspace(-126.5, 127, 256).round(0) + 0.5
    x[0, 0] = 127.0
    x[1] = 0.0                                   # the 1e-20 floor
    for dim in (-1, 0):
        q, s = tc.quant_rows(torch.from_numpy(x), dim)
        jq, js = jc.quant_rows(jnp.asarray(x), axis=dim)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.dequant_rows(q, s).numpy(),
                                      np.asarray(jc.dequant_rows(jq, js)))


def test_quant_rows_roundtrip_error():
    x = torch.randn((64, 256), generator=torch.Generator().manual_seed(0))
    q, s = tc.quant_rows(x)
    err = (tc.dequant_rows(q, s) - x).abs()
    assert float(err.max()) <= float(s.max()) * 0.51


def test_wire_bytes_model():
    m = tc.wire_bytes_saved(1_000_000, 256)
    assert m == jc.wire_bytes_saved(1_000_000, 256)
    assert 3.5 < m["ratio"] < 4.1


def test_error_feedback_removes_bias():
    """Repeatedly compressing the same vector with EF: the time-average of
    the decoded output converges to the true value (unbiasedness)."""
    g = torch.randn((512,), generator=torch.Generator().manual_seed(1))
    err = torch.zeros((512,))
    decoded_sum = torch.zeros((512,))
    steps_ = 200
    for _ in range(steps_):
        seg = g + err
        q, s = tc.quant_rows(seg.reshape(2, 256))
        dec = tc.dequant_rows(q, s).reshape(512)
        err = seg - dec
        decoded_sum = decoded_sum + dec
    np.testing.assert_allclose((decoded_sum / steps_).numpy(), g.numpy(),
                               atol=5e-3)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_init_error_state_shapes(n):
    tree = {"w": np.ones((1000,), np.float32), "b": np.ones((3,), np.float32),
            "l": {"k": np.ones((7, 300), np.float32)}}
    got = tc.init_error_state(bridge.to_torch(tree), n)
    want = jc.init_error_state(tree, n)
    for (k, a), (_, b) in zip(leaves_with_path(got), leaves_with_path(want)):
        assert tuple(a.shape) == tuple(b.shape), k
        assert a.shape[0] * n % 256 == 0 and a.dtype == torch.float32
        assert not bool(a.any())
    glob = steps.init_error_state_global(bridge.to_torch(tree), n)
    jglob = jsteps.init_error_state_global(tree, n)
    assert [tuple(v.shape) for _, v in leaves_with_path(glob)] == \
        [tuple(v.shape) for _, v in leaves_with_path(jglob)]


def _close_tree(got, want, what: str):
    want = dict(leaves_with_path(want))
    for k, g in leaves_with_path(got):
        np.testing.assert_allclose(as_np(g), as_np(want[k]), rtol=0,
                                   atol=TOL, err_msg=f"{what} {k}")


def _ties(got: np.ndarray, want: np.ndarray) -> int:
    """Residual entries more than TOL apart. Each must be a rounding tie:
    the segment entry sat on .5 of its int8 step, the two frameworks
    rounded it to neighbouring codes, and the residuals are +s/2 and -s/2
    of the row scale s (so they sum to 0)."""
    off = np.abs(got - want) > TOL
    assert (np.abs(got[off] + want[off]) <= TOL).all(), (got[off], want[off])
    return int(off.sum())


def test_compressed_mean_single_device_matches_reference():
    """n = 1: the port's tree_compressed_psum_mean with no process group,
    fed the reference's gradients and a nonzero residual, equals the
    reference's under shard_map on its one CPU device."""
    jm, jp, m, p = models(ARCH)
    b = batch(m.cfg, 2, 17)
    _, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jax_batch(b))
    err = jax.tree.map(lambda e: 1e-3 * jnp.sin(jnp.arange(e.shape[0],
                                                           dtype=jnp.float32)),
                       jsteps.init_error_state_global(jp, 1))
    mesh = make_host_mesh(model_axis=1)
    ref = jax.jit(shard_map(
        lambda g, e: jc.tree_compressed_psum_mean(g, e, "data"), mesh=mesh,
        in_specs=(P(), P("data")), out_specs=(P(), P("data")),
        check_vma=False))
    jgm, jerr = ref(jg, err)
    tgm, terr = tc.tree_compressed_psum_mean(
        bridge.to_torch(jax.tree.map(np.asarray, jg)),
        bridge.to_torch(jax.tree.map(np.asarray, err)))
    _close_tree(tgm, jgm, "grad")
    _close_tree(terr, jerr, "err")


def test_compressed_step_single_device_matches_reference():
    """n = 1: the whole compressed step (its own gradients) on the
    reference's weights against the reference's shard_map step, two steps,
    each from the reference's state crossed to the port: loss rtol 1e-5;
    residuals within 1e-6 but for ties (counted); params within 1e-6 but
    for the entries a tie moved."""
    jm, jp, m, _ = models(ARCH)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg, tcfg = ja.AdamConfig(**kw), ta.AdamConfig(**kw)
    jo = jax_init(ja.opt_state_decls(jm.param_decls(), jcfg),
                  jax.random.PRNGKey(0), "float32")
    jo["err"] = jsteps.init_error_state_global(jp, 1)
    jstep = jax.jit(jsteps.make_dp_compressed_train_step(
        jm, jcfg, make_host_mesh(model_axis=1)))
    tstep = steps.make_dp_compressed_train_step(m, tcfg)
    ties = []
    for i in range(2):
        p = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp))
        to = bridge.lm_opt_state_from_numpy(jax.tree.map(np.asarray, jo))
        b = batch(m.cfg, 4, 16, seed=i)
        jp, jo, jmet = jstep(jp, jo, jax_batch(b))
        p, to, tmet = tstep(p, to, torch_batch(b))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        want = dict(leaves_with_path(jo["err"]))
        n = sum(_ties(as_np(g), as_np(want[k]))
                for k, g in leaves_with_path(to["err"]))
        want = dict(leaves_with_path(jp))
        moved = sum(int((np.abs(as_np(g) - as_np(want[k])) > TOL).sum())
                    for k, g in leaves_with_path(p))
        assert moved <= n <= 4, (i, moved, n)
        ties.append(n)
    print(f"{ARCH} compressed step n=1: residual ties per step {ties}")


_FLAT = """
def flat(t, pre=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + k + "/"))
        else:
            out[pre + k] = np.asarray(v)
    return out

def unflat(z, pre):
    root = {}
    for key in z.files:
        if key.startswith(pre):
            *path, last = key[len(pre):].split("/")
            d = root
            for q in path:
                d = d.setdefault(q, {})
            d[last] = z[key]
    return root
"""

# the reference on 2 fake CPU devices: each device's gradients of its half
# of the batch, their compressed mean under shard_map, and the whole
# compressed step (batch sharded over "data")
_REFERENCE_2DEV = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import smoke_config
from repro.launch import steps
from repro.launch.mesh import make_host_mesh
from repro.models.model_zoo import build_model
from repro.models.params import init_params
from repro.optim.adam import AdamConfig, opt_state_decls
from repro.runtime.compat import shard_map
from repro.runtime.compression import tree_compressed_psum_mean
""" + _FLAT + """
assert len(jax.devices()) == 2
cfg = smoke_config(ARCH)
m = build_model(cfg)
params = init_params(m.param_decls(), jax.random.PRNGKey(0), cfg.param_dtype)
rng = np.random.default_rng(0)
tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
b = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(np.roll(tokens, -1, 1))}
mesh = make_host_mesh(model_axis=1)
acfg = AdamConfig(lr=1e-3, warmup_steps=1, total_steps=10)
opt = init_params(opt_state_decls(m.param_decls(), acfg), jax.random.PRNGKey(0),
                  "float32")
err0 = jax.tree.map(
    lambda e: 1e-3 * jnp.sin(jnp.arange(e.shape[0], dtype=jnp.float32)),
    steps.init_error_state_global(params, 2))
opt["err"] = err0
vg = jax.jit(jax.value_and_grad(m.loss))
local = [vg(params, {k: v[2 * i:2 * i + 2] for k, v in b.items()})[1]
         for i in range(2)]
mean = jax.jit(shard_map(
    lambda g, e: tree_compressed_psum_mean(jax.tree.map(lambda x: x[0], g), e,
                                           "data"),
    mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P(), P("data")),
    check_vma=False))
gm, e1 = mean(jax.tree.map(lambda *a: jnp.stack(a), *local), err0)
p1, o1, met = jax.jit(steps.make_dp_compressed_train_step(m, acfg, mesh))(
    params, opt, b)
out = {"tokens": tokens, "loss": np.asarray(met["loss"])}
for pre, t in (("params/", params), ("err0/", err0), ("gm/", gm), ("e1/", e1),
               ("p1/", p1), ("step_err/", o1["err"]),
               ("local0/", local[0]), ("local1/", local[1])):
    out.update(flat(t, pre))
np.savez(PATH, **out)
print("ALL OK")
"""

# one rank of the port's 2-process gloo group: the compressed mean of the
# reference's gradients of this rank's half, then the whole compressed step
_PORT_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.launch import steps
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adam as ta
from repro_torch.runtime import compression as tc
""" + _FLAT + """
rank, port, path, arch = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
z = np.load(path)
params = bridge.to_torch(unflat(z, "params/"))
mine = lambda e: e[rank * (e.shape[0] // 2):(rank + 1) * (e.shape[0] // 2)]
err0 = ta.tree_unflatten(params, [mine(e) for e in ta.tree_leaves(
    bridge.to_torch(unflat(z, "err0/")))])
gm, e1 = tc.tree_compressed_psum_mean(
    bridge.to_torch(unflat(z, f"local{rank}/")), err0)
zeros = lambda: ta.tree_unflatten(params, [torch.zeros_like(x)
                                           for x in ta.tree_leaves(params)])
opt = {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32),
       "err": err0}
tok = torch.from_numpy(z["tokens"][2 * rank:2 * rank + 2])
batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
cfg = ta.AdamConfig(lr=1e-3, warmup_steps=1, total_steps=10)
p1, o1, met = steps.make_dp_compressed_train_step(
    build_model(smoke_config(arch)), cfg)(params, opt, batch)
out = {"loss": met["loss"].numpy()}
for pre, t in (("gm/", gm), ("e1/", e1), ("p1/", p1), ("step_err/", o1["err"])):
    out.update(flat(bridge.to_numpy(t), pre))
np.savez(path.replace(".npz", f"_rank{rank}.npz"), **out)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tree(z, pre: str) -> dict:
    return {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}


def test_compressed_step_two_ranks_gloo_matches_reference(fake_devices,
                                                          tmp_path):
    """n = 2: two gloo ranks of the port against the reference's shard_map
    over 2 fake CPU devices. The compressed mean of the reference's
    per-device gradients: the mean gradient (the same on both ranks) and
    each rank's residual segment within 1e-6. The whole step (each side's
    own gradients): the loss at rtol 1e-5, the residuals within 1e-6 except
    entries one int8 code apart (counted)."""
    path = str(tmp_path / "ref.npz")
    fake_devices(f"ARCH, PATH = {ARCH!r}, {path!r}\n" + _REFERENCE_2DEV,
                 n_devices=2)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_RANK, str(r), port,
                               path, ARCH], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for pr in procs:
        _, err = pr.communicate(timeout=300)
        assert pr.returncode == 0, err[-3000:]
    ref = np.load(path)
    for rank in range(2):
        got = np.load(path.replace(".npz", f"_rank{rank}.npz"))
        half = lambda e: e[rank * (e.shape[0] // 2):(rank + 1) * (e.shape[0] // 2)]
        for k, v in _tree(ref, "gm/").items():
            np.testing.assert_allclose(got["gm/" + k], v, rtol=0, atol=TOL,
                                       err_msg=f"rank {rank} grad {k}")
        for k, v in _tree(ref, "e1/").items():
            np.testing.assert_allclose(got["e1/" + k], half(v), rtol=0,
                                       atol=TOL, err_msg=f"rank {rank} err {k}")
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                                   rtol=1e-5)
        n = sum(_ties(got["step_err/" + k], half(v))
                for k, v in _tree(ref, "step_err/").items())
        moved = sum(int((np.abs(got["p1/" + k] - v) > TOL).sum())
                    for k, v in _tree(ref, "p1/").items())
        print(f"{ARCH} compressed step n=2 rank {rank}: residual ties {n}, "
              f"params moved by them {moved}")
        assert moved <= n <= 4, (rank, moved, n)
