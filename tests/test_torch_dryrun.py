"""The port's dry run against the JAX package's.

The reference's dry run cannot run in a test process (it must fix 512
host devices before jax starts), so what is held to it is its pure logic:
the collective parser, ``sharded_bytes`` and ``model_flops`` on every arch
x shape on both production meshes, and the models' input specs, all
exact. The port's cells run at smoke size (the families' smoke configs at
reduced shapes of the same names) on the fake 16 x 16 mesh: their JSON
keys, the analytic numbers against the reference's functions, a useful-
FLOP ratio in (0, 1.05], fake or meta leaves only, the probes' linearity
(1e-6 relative) and per-device FLOPs counted at local shapes (exact).
"""
import json
import os

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.nerf_icarus import CONFIG as JNERF
from repro.core.plcore import plcore_decls as jax_plcore_decls
from repro.models.model_zoo import build_model as jax_build
from repro.models.params import param_count as jax_param_count
from repro.optim import adam as jadam
from repro.runtime.sharding import Rules as JRules

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adam import AdamConfig, opt_state_decls
from repro_torch.runtime.sharding import Rules

LM_KEYS = {"arch", "shape", "optimized", "mesh", "chips",
           "hlo_flops_per_device", "hlo_bytes_per_device",
           "collective_wire_bytes", "collectives", "scan_raw", "probe",
           "memory_analysis", "param_bytes_per_device",
           "state_bytes_per_device", "param_count", "model_flops_global",
           "model_flops_per_device", "roofline", "useful_flops_ratio",
           "lower_s", "compile_s", "dominant", "counted_by"}
NERF_KEYS = {"arch", "shape", "optimized", "mesh", "chips",
             "hlo_flops_per_device", "hlo_bytes_per_device", "collectives",
             "param_count", "model_flops_global", "model_flops_per_device",
             "roofline", "useful_flops_ratio", "lower_s", "compile_s",
             "dominant", "counted_by"}
# one arch per family, at the smoke configs
FAMILIES = ["qwen2-1.5b", "moonshot-v1-16b-a3b", "mamba2-2.7b",
            "recurrentgemma-9b", "whisper-large-v3", "paligemma-3b"]
# the assigned shapes' names at smoke size (batch divisible by 16)
SMALL = {"train_4k": ("train_4k", 32, 16, "train"),
         "prefill_32k": ("prefill_32k", 64, 16, "prefill"),
         "decode_32k": ("decode_32k", 64, 16, "decode"),
         "long_500k": ("long_500k", 128, 16, "decode")}


@pytest.fixture(autouse=True)
def _no_group_left_and_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    assert not dist.is_initialized()


@pytest.fixture
def ref_dryrun(monkeypatch):
    """The reference's dry-run module. Its import sets XLA_FLAGS to 512
    host devices; jax is started first (one device, as the suite needs)
    and the variable is restored after the test."""
    jax.devices()
    if "XLA_FLAGS" in os.environ:
        monkeypatch.setenv("XLA_FLAGS", os.environ["XLA_FLAGS"])
    else:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    from repro.launch import dryrun as ref
    return ref


def _meshes():
    for mp in (False, True):
        shape, names = PRODUCTION_SHAPES[mp]
        yield AbstractMesh(shape, names), dict(zip(names, shape))


def test_collective_bytes_parser(ref_dryrun):
    hlo = """
  %ag = bf16[8,128]{1,0} all-gather(bf16[1,128]{1,0} %p), replica_groups={}
  %ar = f32[256]{0} all-reduce(f32[256]{0} %q), to_apply=%add
  %cp = f32[2,2]{1,0} collective-permute(f32[2,2]{1,0} %r)
  %dn = bf16[8,128]{1,0} all-gather-done(bf16[8,128]{1,0} %ag)
"""
    out = dryrun.collective_bytes(hlo)
    assert out == ref_dryrun.collective_bytes(hlo)
    assert out["op_counts"]["all-gather"] == 1
    assert out["wire_bytes"] == 8 * 128 * 2 + 2 * 256 * 4 + 16


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_terms_match_reference(arch, ref_dryrun):
    """sharded_bytes of params, optimizer state (f32 and int8) and caches,
    and model_flops, for every shape on both production meshes: exact."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    m, jm = build_model(cfg), jax_build(jcfg)
    rules, jrules = Rules(), JRules()
    trees = [(m.param_decls(), jm.param_decls(), cfg.param_dtype)]
    for md in ("float32", "int8"):
        trees.append((opt_state_decls(trees[0][0], AdamConfig(moment_dtype=md)),
                      jadam.opt_state_decls(trees[0][1],
                                            jadam.AdamConfig(moment_dtype=md)),
                      "float32"))
    for s in cfg.shapes():
        B, S = s.global_batch, s.seq_len
        trees.append((m.cache_decls(B, S), jm.cache_decls(B, S), "bfloat16"))
        js = JShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)
        assert dryrun.model_flops(cfg, s) == ref_dryrun.model_flops(jcfg, js)
    for jmesh, mesh in _meshes():
        for ours, ref, dt in trees:
            assert dryrun.sharded_bytes(ours, mesh, rules, dt) == \
                ref_dryrun.sharded_bytes(ref, jmesh, jrules, dt)


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(arch):
    m, jm = build_model(get_config(arch)), jax_build(jax_get_config(arch))
    for s in get_config(arch).shapes():
        js = JShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)
        ours, ref = m.input_specs(s), jm.input_specs(js)
        assert sorted(ours) == sorted(ref)
        for k, t in ours.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape)
            assert str(t.dtype).split(".")[-1] == str(ref[k].dtype)
        assert m.input_logical(s) == jm.input_logical(js)


def _small_shapes(monkeypatch):
    monkeypatch.setattr(dryrun, "SHAPES",
                        {k: ShapeSpec(*v) for k, v in SMALL.items()})
    monkeypatch.setattr(dryrun, "get_config", smoke_config)


def _spy_storage(monkeypatch) -> list:
    verdicts = []
    real = dryrun.all_fake_or_meta

    def spy(tree):
        verdicts.append(real(tree))
        return verdicts[-1]
    monkeypatch.setattr(dryrun, "all_fake_or_meta", spy)
    return verdicts


@pytest.mark.parametrize("arch,shape", [(a, "train_4k") for a in FAMILIES]
                         + [("qwen2-1.5b", "prefill_32k"),
                            ("mamba2-2.7b", "decode_32k")])
def test_lm_cell_at_smoke_size(arch, shape, monkeypatch, ref_dryrun):
    _small_shapes(monkeypatch)
    verdicts = _spy_storage(monkeypatch)
    r = dryrun.lower_cell(arch, shape, multi_pod=False, verbose=False,
                          probes=False)
    assert set(r) == LM_KEYS
    assert verdicts and all(verdicts)
    jcfg = jax_smoke_config(arch)
    jm, jmesh = jax_build(jcfg), AbstractMesh((16, 16), ("data", "model"))
    js = JShapeSpec(*SMALL[shape])
    assert r["param_count"] == jax_param_count(jm.param_decls())
    assert r["model_flops_global"] == ref_dryrun.model_flops(jcfg, js)
    assert r["param_bytes_per_device"] == ref_dryrun.sharded_bytes(
        jm.param_decls(), jmesh, JRules(), jcfg.param_dtype)
    if js.kind == "train":
        want = ref_dryrun.sharded_bytes(
            jadam.opt_state_decls(jm.param_decls(), jadam.AdamConfig(
                moment_dtype=jcfg.moment_dtype)), jmesh, JRules(), "float32")
    else:
        want = ref_dryrun.sharded_bytes(
            jm.cache_decls(js.global_batch, js.seq_len), jmesh, JRules(),
            "bfloat16")
    assert r["state_bytes_per_device"] == want
    assert 0 < r["useful_flops_ratio"] <= 1.05
    assert r["chips"] == 256 and r["mesh"] == {"data": 16, "model": 16}
    assert r["dominant"] in r["roofline"]
    assert r["hlo_flops_per_device"] == r["scan_raw"]["flops"] > 0
    assert set(r["collectives"]) == {"result_bytes", "op_counts", "wire_bytes"}
    for entry in r["counted_by"]["analytic"].values():
        assert entry["calls"] > 0 and entry["why"]
    json.dumps(r)


def test_nerf_cell_and_cli(tmp_path, ref_dryrun):
    """render_quarter through the CLI: the reference's nerf key set, one
    JSON per cell, the plain route (no kernel), the reference's counts."""
    dryrun.main(["--arch", "nerf-icarus", "--shape", "render_quarter",
                 "--out", str(tmp_path)])
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == ["nerf-icarus_render_quarter_16x16.json"]
    r = json.loads(files[0].read_text())
    assert set(r) == NERF_KEYS
    pc = jax_param_count(jax_plcore_decls(JNERF))
    assert r["param_count"] == pc
    n_evals = 400 * 400 * (JNERF.n_coarse * 2 + JNERF.n_fine)
    assert r["model_flops_global"] == 2.0 * (pc / 2) * n_evals
    assert 0 < r["useful_flops_ratio"] <= 1.05
    assert r["collectives"]["wire_bytes"] == 0       # rays are independent


def test_probe_extrapolation_is_linear(monkeypatch):
    n_layers = 4
    _small_shapes(monkeypatch)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: smoke_config(a).replace(n_layers=n_layers))
    r = dryrun.lower_cell("qwen2-1.5b", "prefill_32k", multi_pod=False,
                          verbose=False, probes=True)
    p = r["probe"]
    assert p["k"] == [2, 4] and p["units_full"] == n_layers
    for key in ("flops", "bytes", "wire_bytes"):
        assert p["extrapolated"][key] == pytest.approx(r["scan_raw"][key],
                                                       rel=1e-6)


def test_per_device_flops_are_local_shapes():
    """A product sharded over 256 ranks counts 2 m k n of its local shards,
    not of the global product."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    M, K, N = 512, 256, 1024
    with make_production_mesh() as mesh:
        fm = FakeTensorMode(allow_non_fake_inputs=True)
        x = dryrun._dtensor((M, K), torch.float32, ("data", None), mesh, fm)
        w = dryrun._dtensor((K, N), torch.float32, (None, "model"), mesh, fm)
        counter, out, _ = dryrun._trace(lambda: x @ w, fm)
        assert tuple(out.to_local().shape) == (M // 16, N // 16)
    assert counter.flops == 2 * (M // 16) * K * (N // 16)
    assert counter.flops * 256 == 2 * M * K * N
    assert counter.coll_counts == {k: 0 for k in counter.coll_counts}


def test_opt_refused_and_default_out():
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        dryrun.main(["--opt", "--arch", "qwen2-1.5b"])
    with pytest.raises(NotImplementedError):
        dryrun.lower_cell("qwen2-1.5b", "train_4k", multi_pod=False,
                          optimized=True)
    assert dryrun.DEFAULT_OUT == "runs/dryrun_torch"
    assert not dryrun.DEFAULT_OUT.rstrip("/").endswith("runs/dryrun")


def test_no_kernel_under_the_nerf_trace():
    from repro_torch.kernels import ops as kops

    real = kops.fused_render
    with dryrun._no_kernels():
        with pytest.raises(AssertionError, match="kernels.ops"):
            kops.fused_render()
    assert kops.fused_render is real
