"""The port's logical axes and sharding rules against the JAX package.

Decl trees (shape, logical axes, init, scale, dtype) of every arch at its
full config, its caches and its optimizer state, and of the PLCore, must
equal the reference's exactly. ``Rules`` must give the reference's specs
on every decl at (1, 1), (16, 16), (2, 16, 16) and a mesh whose axes do
not divide, with the reference meshes ``jax.sharding.AbstractMesh`` (no
devices) and the port's the same ``{name: size}`` mapping. Everything
here is exact: the rules are integer logic.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs.nerf_icarus import CONFIG as JNERF
from repro.core.plcore import PlcoreModel as JPlcoreModel
from repro.core.plcore import plcore_decls as jax_plcore_decls
from repro.models.model_zoo import build_model as jax_build
from repro.models.params import is_decl as jax_is_decl
from repro.optim import adam as jadam
from repro.runtime import sharding as jsh

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.nerf_icarus import CONFIG as NERF
from repro_torch.core.plcore import PlcoreModel, plcore_decls
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import Decl, abstract_params, is_decl
from repro_torch.optim import adam
from repro_torch.runtime import sharding as sh

MESHES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((3, 5), ("data", "model"))]
CACHE_BS = (128, 32768)          # decode_32k's batch and capacity


def _flat_ref(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jax_is_decl)[0]
    return {tuple(k.key for k in path): d for path, d in leaves}


def _flat(tree, path=()) -> dict:
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)))
    return out


def _fields(d) -> tuple:
    return (tuple(d.shape), tuple(d.logical), d.init, d.scale, d.dtype)


def _same_tree(ours, ref):
    a, b = _flat(ours), _flat_ref(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert _fields(a[k]) == _fields(b[k]), k


def _trees(arch):
    """(port decls, reference decls) of every tree the dry run lays out."""
    m, jm = build_model(get_config(arch)), jax_build(jax_get_config(arch))
    out = [(m.param_decls(), jm.param_decls()),
           (m.cache_decls(*CACHE_BS), jm.cache_decls(*CACHE_BS))]
    for md in ("float32", "int8"):
        out.append((adam.opt_state_decls(out[0][0], adam.AdamConfig(moment_dtype=md)),
                    jadam.opt_state_decls(out[0][1], jadam.AdamConfig(moment_dtype=md))))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_decl_trees_match_reference(arch):
    for ours, ref in _trees(arch):
        _same_tree(ours, ref)


def test_plcore_decls_match_reference():
    _same_tree(plcore_decls(NERF), jax_plcore_decls(JNERF))
    _same_tree(PlcoreModel(NERF).param_decls(), JPlcoreModel(JNERF).param_decls())


def test_decl_checks_logical_length_and_abstract_params_are_meta():
    with pytest.raises(AssertionError):
        Decl((2, 3), ("embed",))
    decls = plcore_decls(NERF)
    tree = abstract_params(decls, "float32")
    for path, d in _flat(decls).items():
        t = tree
        for k in path:
            t = t[k]
        assert t.device.type == "meta" and tuple(t.shape) == d.shape
        assert t.dtype == torch.float32


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("shape,names", MESHES)
def test_rules_match_reference(arch, shape, names):
    """resolve, spec_for (through pspecs), batch_axes and batch_spec."""
    jmesh, mesh = AbstractMesh(shape, names), dict(zip(names, shape))
    rules, jrules = sh.Rules(), jsh.Rules()
    for ours, ref in _trees(arch):
        got = _flat(sh.pspecs(ours, mesh, rules))
        want = {k: tuple(jrules.spec_for(d, jmesh))
                for k, d in _flat_ref(ref).items()}
        assert got == want
        for d in _flat(ours).values():
            for dim, name in zip(d.shape, d.logical):
                assert rules.resolve(name, mesh, dim) == \
                    jrules.resolve(name, jmesh, dim)
    assert rules.batch_axes(mesh) == jrules.batch_axes(jmesh)
    for ndim, bdim in ((2, 0), (3, 1)):
        assert rules.batch_spec(mesh, ndim, bdim) == \
            tuple(jrules.batch_spec(jmesh, ndim, bdim))
    # the port's rules read a DeviceMesh-like object's axis sizes too
    assert rules.batch_axes(jmesh) == jrules.batch_axes(jmesh)


# the reference's own three rule tests (tests/test_runtime.py), on the port
def test_rules_drop_non_dividing_axes():
    r = sh.Rules()
    mesh = {"data": 1, "model": 1}
    # 16-wide model axis can't split 2 kv heads -> replicated
    assert r.resolve("kvheads", mesh, 2) is None or mesh["model"] == 1
    assert r.resolve("kvheads", {"data": 16, "model": 16}, 2) is None
    assert r.resolve("kvheads", {"data": 16, "model": 16}, 32) == "model"


def test_rules_spec_no_duplicate_axes():
    d = Decl((64, 64), ("embed", "ffn"))
    spec = sh.Rules().spec_for(d, {"data": 1, "model": 1})
    axes = [a for part in spec if part is not None
            for a in (part if isinstance(part, tuple) else (part,))]
    assert len(axes) == len(set(axes))


def test_rules_fsdp_toggle():
    d = Decl((64, 128), ("embed", "ffn"))
    mesh = {"data": 1, "model": 1}
    off = dataclasses.replace(sh.Rules(), fsdp=False).spec_for(d, mesh)
    assert off[0] is None
    assert sh.Rules().spec_for(d, mesh)[0] == "data"


@pytest.mark.parametrize("shape,names", MESHES)
def test_attention_rules_match_reference(shape, names):
    jmesh, mesh = AbstractMesh(shape, names), dict(zip(names, shape))
    try:
        jsh.set_activation_context(jmesh)
        sh.set_activation_context(mesh)
        assert sh.activation_context_mesh() is mesh
        for b in (1, 8, 32, 128, 256, 512, 4096):
            assert sh.attn_batch_split_ok(b) == jsh.attn_batch_split_ok(b)
        for h in (1, 8, 12, 16, 20, 32, 40, 64):
            assert sh.attn_needs_batch_reshard(h) == \
                jsh.attn_needs_batch_reshard(h)
    finally:
        jsh.set_activation_context(None)
        sh.set_activation_context(None)
    assert not sh.attn_batch_split_ok(256)
    assert not sh.attn_needs_batch_reshard(12)


def test_constrain_logical_logits_placement(monkeypatch):
    """On a fake 16 x 16 mesh the logits (B, S, V) take the placements of
    the spec the reference's rule resolves; plain tensors and a missing
    context pass through."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    B, S, V = 256, 8, 151936
    logical = ("batch", None, "vocab")
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: s)
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    try:
        jsh.set_activation_context(jmesh)
        want = tuple(jsh.constrain_logical(
            jax.ShapeDtypeStruct((B, S, V), np.float32), logical).spec)
    finally:
        jsh.set_activation_context(None)
    assert want == ("data", None, "model")

    plain = torch.zeros(2, 2)
    assert sh.constrain_logical(plain, logical) is plain     # no context
    with make_production_mesh() as mesh:
        with FakeTensorMode():
            local = torch.empty(B // 16, S, V, device="meta")
        x = DTensor.from_local(local, mesh, [Shard(0), Replicate()],
                               run_check=False, shape=(B, S, V),
                               stride=(S * V, V, 1))
        try:
            sh.set_activation_context(mesh)
            assert sh.logical_spec((B, S, V), logical, mesh, sh.Rules()) == want
            y = sh.constrain_logical(x, logical)
            assert sh.constrain_logical(plain, logical) is plain
        finally:
            sh.set_activation_context(None)
        assert list(y.placements) == sh.placements(want, mesh)
        assert tuple(y.to_local().shape) == (B // 16, S, V // 16)
        # shardings: the placement tree of a decl tree
        d = {"w": Decl((1536, 8960), ("embed", "ffn"))}
        assert sh.shardings(d, mesh, sh.Rules())["w"] == [Shard(0), Shard(1)]
    assert not torch.distributed.is_initialized()
