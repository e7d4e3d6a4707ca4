"""The models' mesh paths on real ranks against the reference's own mesh
paths.

The reference runs through the ``fake_devices`` fixture on 8 fake CPU
devices as a ("data", "model") = (2, 4) ``jax.sharding.Mesh`` with Auto
axes (``jax.make_mesh``'s Explicit default is what breaks
``tests/test_opt_sharding.py`` under jax 0.9): the two cases of that test
(qwen2 with 6 heads takes the batch-split attention, moonshot smoke the
expert-parallel MoE), loss and gradients with the activation context
installed and without, and one MoE layer with capacity drops. The port
runs on 8 spawned ``gloo`` ranks at (2, 4), params and batch DTensors
laid out by ``Rules``, the step under ``runtime.spmd``, on the
reference's weights and tokens: loss within 1e-4 (batch split) / 1e-3
(EP) of the reference's mesh run, every gradient leaf (``full_tensor``)
within 1e-3 of the reference's largest |g|, both also against the port's
mesh-free path; EP with drops in ``y`` and aux against the reference's EP
(not its dense path); the guards; the logits' vocab-sharded placement.
Then 4 ranks: ``make_host_mesh(2)`` and ``train --smoke --model-axis 2``
(3 steps' losses within 1e-5 relative of ``--model-axis 1``). Each rank
group is spawned once for the file.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as M
from repro_torch.launch.train import build_parser, run

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = {"split": 1e-4, "ep": 1e-3}
GRAD_TOL = 1e-3          # of the reference's largest |g|
DROP_CF = 0.5            # capacity factor of the drop case

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

# the two cases of tests/test_opt_sharding.py, configs built the same way
# on both sides
_CASES = """
def case_cfg(smoke_config, name):
    if name == "split":
        return smoke_config("qwen2-1.5b").replace(
            n_heads=6, n_kv_heads=2, d_model=96, head_dim=16, d_ff=128)
    return smoke_config("moonshot-v1-16b-a3b")
"""

_REFERENCE = _FLAT + _CASES + r"""
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import smoke_config
from repro.models import moe
from repro.models.model_zoo import build_model
from repro.models.params import init_params
from repro.runtime.sharding import Rules, set_activation_context

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
out = {}
for name in ("split", "ep"):
    cfg = case_cfg(smoke_config, name)
    m = build_model(cfg)
    params = init_params(m.param_decls(), jax.random.PRNGKey(0),
                         cfg.param_dtype)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 32))
    batch = {"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(np.roll(toks, -1, 1), jnp.int32)}
    vg = jax.jit(jax.value_and_grad(m.loss))
    l0, g0 = vg(params, batch)
    set_activation_context(mesh, Rules())
    try:
        l1, g1 = jax.jit(jax.value_and_grad(m.loss))(params, batch)
    finally:
        set_activation_context(None)
    out.update(flat(params, name + "/params/"))
    out.update(flat(g1, name + "/grads/"))
    out[name + "/tokens"] = toks.astype(np.int32)
    out[name + "/loss"] = np.asarray(l1)
    out[name + "/loss_plain"] = np.asarray(l0)

# one MoE layer with capacity drops, EP against dense
cfg = smoke_config("moonshot-v1-16b-a3b")
cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=CF))
lp = init_params(build_model(cfg).param_decls(), jax.random.PRNGKey(2),
                 cfg.param_dtype)["layers"]
lp = jax.tree.map(lambda a: a[0], lp)
x = np.random.default_rng(3).standard_normal((8, 32, cfg.d_model)).astype(np.float32)
set_activation_context(mesh, Rules())
try:
    y, aux = jax.jit(lambda lp, x: moe.moe_apply(cfg, lp, x))(lp, jnp.asarray(x))
finally:
    set_activation_context(None)
yd, auxd = moe._moe_apply_dense(cfg, lp, jnp.asarray(x))
out.update(flat(lp, "drops/lp/"))
out.update({"drops/x": x, "drops/y": np.asarray(y), "drops/aux": np.asarray(aux),
            "drops/y_dense": np.asarray(yd), "drops/aux_dense": np.asarray(auxd)})
np.savez(PATH, **out)
print("ALL OK")
"""

# every rank of the 8-rank group: the two cases on DTensors at (2, 4) and
# mesh-free, the drop case, the guards, the logits' placement
_PORT_PATHS = _FLAT + _CASES + r"""
import dataclasses, json, os, sys
import numpy as np
import torch
from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import loss_and_grads
from repro_torch.launch.train import _mesh_batch
from repro_torch.models import blocks, moe
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import init_params
from repro_torch.runtime import spmd
from repro_torch.runtime.sharding import Rules, set_activation_context

torch.set_num_threads(1)
path = sys.argv[1]
z = np.load(path)
taken = {"split": 0, "ep": 0}
def counted(fn, key):
    def wrapped(*a, **k):
        taken[key] += 1
        return fn(*a, **k)
    return wrapped
blocks._batch_split_attention = counted(blocks._batch_split_attention, "split")
moe._moe_apply_ep = counted(moe._moe_apply_ep, "ep")

def on_mesh(mesh, rules, model, params, batch):
    dp = spmd.distribute_tree(params, model.param_decls(), mesh, rules)
    db = _mesh_batch(batch, mesh, rules)
    set_activation_context(mesh, rules)
    try:
        with spmd.sharded_program() as mode:
            loss, g = loss_and_grads(spmd.FsdpLoss(model, mesh, rules).loss,
                                     dp, db)
            loss, g = loss.full_tensor(), spmd.full_tree(g)
    finally:
        set_activation_context(None)
    return loss, g, mode

out, info = {}, {}
with make_host_mesh(4, device="cpu") as mesh:
    rules = Rules()
    rank = int(os.environ["RANK"])
    for name in ("split", "ep"):
        cfg = case_cfg(smoke_config, name)
        m = build_model(cfg)
        params = bridge.lm_params_from_numpy(unflat(z, name + "/params/"))
        tok = torch.from_numpy(z[name + "/tokens"]).long()
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
        l0, g0 = loss_and_grads(m.loss, params, batch)
        before = dict(taken)
        l1, g1, mode = on_mesh(mesh, rules, m, params, batch)
        info[name] = {"taken": {k: taken[k] - before[k] for k in taken},
                      "analytic": sorted(mode.analytic),
                      "relayout": sorted(mode.relayout)}
        out.update({name + "/loss": l1.numpy(), name + "/loss_plain": l0.numpy()})
        out.update(flat(bridge.to_numpy(g1), name + "/grads/"))
        out.update(flat(bridge.to_numpy(g0), name + "/grads_plain/"))

    # EP with capacity drops: one layer on plain (replicated) tensors
    cfg = smoke_config("moonshot-v1-16b-a3b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=CF))
    lp = bridge.lm_params_from_numpy(unflat(z, "drops/lp/"))
    x = torch.from_numpy(z["drops/x"])
    set_activation_context(mesh, rules)
    try:
        y, aux = moe.moe_apply(cfg, lp, x)
    finally:
        set_activation_context(None)
    out.update({"drops/y": y.numpy(), "drops/aux": aux.numpy()})

    # the guards: a local batch the model axis does not divide; experts
    # the model axis does not divide
    for name, cfg, B in (("guard_split", case_cfg(smoke_config, "split"), 4),
                         ("guard_ep", case_cfg(smoke_config, "ep").replace(
                             moe=dataclasses.replace(
                                 smoke_config("moonshot-v1-16b-a3b").moe,
                                 n_experts=6)), 8)):
        m = build_model(cfg)
        params = init_params(m.param_decls(), torch.Generator().manual_seed(0),
                             cfg.param_dtype)
        tok = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (B, 32)))
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
        l0, _ = loss_and_grads(m.loss, params, batch)
        before = dict(taken)
        l1, _, mode = on_mesh(mesh, rules, m, params, batch)
        info[name] = {"taken": {k: taken[k] - before[k] for k in taken},
                      "loss": float(l1), "loss_plain": float(l0),
                      "analytic": sorted(mode.analytic)}

    # the dense dispatch again with the index ops DTensor's older versions
    # mis-shard forced onto replicated operands (spmd._REPLICATED_OPS)
    cfg = case_cfg(smoke_config, "ep").replace(moe=dataclasses.replace(
        smoke_config("moonshot-v1-16b-a3b").moe, n_experts=6))
    m = build_model(cfg)
    params = init_params(m.param_decls(), torch.Generator().manual_seed(0),
                         cfg.param_dtype)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (8, 32)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    l0, g0 = loss_and_grads(m.loss, params, batch)
    spmd._REPLICATED_OPS = ("index_put", "index_put_", "index_select")
    try:
        l1, g1, mode = on_mesh(mesh, rules, m, params, batch)
    finally:
        spmd._REPLICATED_OPS = ()
    from repro_torch.optim.adam import tree_leaves
    gmax = max(float(g.abs().max()) for g in tree_leaves(g0))
    info["replicated_ops"] = {
        "loss": float(l1), "loss_plain": float(l0), "analytic": sorted(mode.analytic),
        "grad_gap_of_max_g": max(float((a - b).abs().max()) for a, b in
                                 zip(tree_leaves(g1), tree_leaves(g0))) / gmax}

    # the logits' layout under the context
    cfg = case_cfg(smoke_config, "split")
    m = build_model(cfg)
    params = bridge.lm_params_from_numpy(unflat(z, "split/params/"))
    dp = spmd.distribute_tree(params, m.param_decls(), mesh, rules)
    from torch.distributed.tensor import distribute_tensor, Shard, Replicate
    h = distribute_tensor(torch.ones(8, 4, cfg.d_model), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    set_activation_context(mesh, rules)
    try:
        with spmd.sharded_program():
            logits = blocks.logits_out(cfg, spmd.fsdp_gathered(dp, mesh, rules), h)
    finally:
        set_activation_context(None)
    info["logits"] = {"placements": [str(p) for p in logits.placements],
                      "shape": list(logits.shape)}
    with spmd.sharded_program():
        plain = blocks.logits_out(cfg, spmd.fsdp_gathered(dp, mesh, rules), h)
    info["logits_no_context"] = [str(p) for p in plain.placements]
if rank == 0:
    np.savez(path.replace(".npz", "_port.npz"), **out)
    with open(path.replace(".npz", "_port.json"), "w") as f:
        json.dump(info, f)
"""

# every rank of the 4-rank group: the host mesh, its refusal, and the
# driver at --model-axis 2
_PORT_HOST = r"""
import json, os, sys
import torch
import torch.distributed as dist
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch import train

torch.set_num_threads(1)
path, port2 = sys.argv[1], sys.argv[2]
info = {}
with make_host_mesh(2, device="cpu") as mesh:
    info["mesh"] = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
                    "backend": dist.get_backend(), "world": dist.get_world_size()}
info["group_left"] = dist.is_initialized()
try:
    with make_host_mesh(3, device="cpu"):
        info["refused"] = None
except ValueError as e:
    info["refused"] = str(e)
info["group_left_after_refusal"] = dist.is_initialized()
os.environ["MASTER_PORT"] = port2
argv = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "3", "--batch", "8",
        "--seq", "32", "--log-every", "1000", "--device", "cpu",
        "--model-axis", "2"]
info["train"] = train.run(train.build_parser().parse_args(argv))["losses"]
if int(os.environ["RANK"]) == 0:
    with open(path.replace(".npz", "_host.json"), "w") as f:
        json.dump(info, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(code: str, n: int, *argv) -> list:
    """``code`` in ``n`` processes, a torchrun-style gloo launch."""
    port = str(_free_port())
    procs = []
    for r in range(n):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
               "WORLD_SIZE": str(n), "RANK": str(r)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *argv], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _join(procs: list) -> None:
    errs = [p.communicate(timeout=400)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]


@pytest.fixture(scope="module")
def runs(fake_devices, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_paths") / "ref.npz")
    # the 4-rank group needs nothing of the reference: it runs beside it
    host = _start(_PORT_HOST, 4, path, str(_free_port()))
    try:
        fake_devices(f"PATH, CF = {path!r}, {DROP_CF!r}\n" + _REFERENCE)
        _join(_start(f"CF = {DROP_CF!r}\n" + _PORT_PATHS, 8, path))
    finally:
        _join(host)
    load = lambda suffix: json.loads(Path(path.replace(".npz", suffix)).read_text())
    return {"ref": np.load(path),
            "port": np.load(path.replace(".npz", "_port.npz")),
            "info": load("_port.json"), "host": load("_host.json")}


def _tree(z, pre: str) -> dict:
    return {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}


def _hold(runs, name: str):
    ref, port = runs["ref"], runs["port"]
    want = float(ref[name + "/loss"])
    assert abs(float(port[name + "/loss"]) - want) < LOSS_TOL[name]
    assert abs(float(port[name + "/loss"]) - float(port[name + "/loss_plain"])) \
        < LOSS_TOL[name]
    g_ref = _tree(ref, name + "/grads/")
    scale = max(np.abs(v).max() for v in g_ref.values())
    for pre in ("/grads/", "/grads_plain/"):
        got = _tree(port, name + pre)
        assert sorted(got) == sorted(g_ref)
        for k, v in g_ref.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=GRAD_TOL * scale,
                                       err_msg=f"{name}{pre}{k}")


def test_batch_split_attention_matches_reference(runs):
    """qwen2 with 6 heads on a 4-wide model axis: every layer takes the
    batch split (2 layers, remat off: one call each)."""
    assert runs["info"]["split"]["taken"] == {"split": 2, "ep": 0}
    _hold(runs, "split")


def test_expert_parallel_moe_matches_reference(runs):
    """moonshot smoke (8 experts over a 4-wide model axis): the MoE layer
    takes EP; the loss carries data shard 0's aux, as the reference's."""
    assert runs["info"]["ep"]["taken"]["ep"] >= 1
    _hold(runs, "ep")


def test_ep_with_drops_matches_reference_ep(runs):
    """Capacity factor 0.5: EP drops by each data shard's token count, so
    it differs from the dense path; the port holds to the reference's EP."""
    ref, port = runs["ref"], runs["port"]
    np.testing.assert_allclose(port["drops/y"], ref["drops/y"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(port["drops/aux"], ref["drops/aux"], rtol=0,
                               atol=1e-6)
    assert np.abs(ref["drops/y"] - ref["drops/y_dense"]).max() > 1e-3
    assert abs(float(ref["drops/aux"]) - float(ref["drops/aux_dense"])) > 1e-4


@pytest.mark.parametrize("case", ["guard_split", "guard_ep"])
def test_guards_keep_the_mesh_free_paths(runs, case):
    """A local batch of 2 on a 4-wide model axis takes no batch split; 6
    experts on it take no EP (the dense dispatch runs on DTensors, its
    refused ops through the fallback); both equal the mesh-free loss."""
    info = runs["info"][case]
    assert info["taken"] == {"split": 0, "ep": 0}
    assert info["loss"] == pytest.approx(info["loss_plain"], rel=1e-5)
    if case == "guard_ep":
        assert "aten.index_add_.default" in info["analytic"]


def test_replicated_index_ops_keep_the_gradients(runs):
    """The route torch below 2.13 takes (its DTensor mis-shards index_put
    with accumulate and index_select of a partial sum): those ops on
    replicated operands, the dense dispatch's loss and gradients equal the
    mesh-free ones."""
    info = runs["info"]["replicated_ops"]
    assert {"aten.index_select.default", "aten.index_put.default"} \
        <= set(info["analytic"]), info["analytic"]
    assert info["loss"] == pytest.approx(info["loss_plain"], rel=1e-5)
    assert info["grad_gap_of_max_g"] < GRAD_TOL


def test_logits_are_vocab_sharded(runs):
    assert runs["info"]["logits"] == {"placements": ["S(0)", "S(2)"],
                                      "shape": [8, 4, 512]}


def test_host_mesh_on_four_ranks(runs):
    host = runs["host"]
    assert host["mesh"] == {"shape": [2, 2], "names": ["data", "model"],
                            "backend": "gloo", "world": 4}
    assert not host["group_left"] and not host["group_left_after_refusal"]
    assert "does not divide the world size 4" in host["refused"]


def test_train_model_axis_2_matches_model_axis_1(runs):
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "3", "--batch", "8",
            "--seq", "32", "--log-every", "1000", "--device", "cpu"]
    want = run(build_parser().parse_args(argv))["losses"]
    got = runs["host"]["train"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_refusals_without_ranks():
    """One process: a model axis that does not divide the world size, and
    --compress with a model axis."""
    with pytest.raises(ValueError, match="does not divide the world size 1"):
        with M.make_host_mesh(2, device="cpu"):
            pass
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "1", "--device",
            "cpu", "--model-axis", "2", "--compress"]
    with pytest.raises(ValueError, match="--compress"):
        run(build_parser().parse_args(argv))
    assert not torch.distributed.is_initialized()
