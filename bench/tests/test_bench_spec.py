"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding what it names by file: configurations, mixes, metrics and the
model modules a configuration names."""
import hashlib
import json
import math
import re

import pytest
import torch

from bench import harness, spec as S
from bench.tests import cells

ROOT = cells.ROOT
SPEC = S.load(ROOT)
LINE = re.compile(r"[^\t\n\r]{1,200}\Z")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_KEYS = re.compile(r".*(_dim|_rank|width|hidden|intermediate|size)$")


def test_keys_and_limits():
    assert set(SPEC) == KEYS["top"]
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            extra = set(e) - KEYS[group]
            assert extra <= ({"workloads"} if group in ("end_to_end",
                                                        "per_layer")
                             else set()), (group, e["name"], extra)
            assert KEYS[group] <= set(e), (group, e["name"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert len(SPEC["command"]) <= 32
    assert all(LINE.match(w) for w in SPEC["command"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for e in SPEC[group]:
        assert S.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert S.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer", "source"):
            if k in e and isinstance(e[k], str):
                assert LINE.match(e[k]), (e["name"], k)
    for e in SPEC["workloads"]:
        assert S.NAME.match(e["config"]) and S.NAME.match(e["traffic"])
        assert e["chips"] in (1, 4)


def test_metric_names_are_unique_across_groups():
    names = [m["name"] for g in ("end_to_end", "per_layer") for m in SPEC[g]]
    assert len(names) == len(set(names))


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in S.cell_metrics(SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert S.cell_metrics(SPEC, cell, True)


def test_moves_names_a_metric_every_listed_cell_reports():
    layers = {}
    for m in SPEC["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            e2e = [x["name"] for x in S.cell_metrics(SPEC, cell, False)]
            assert m["moves"] in e2e, (m["name"], cell)
        layers.setdefault(m["layer"], m["name"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


def test_roofline_and_mfu_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"].endswith("_roofline") for m in SPEC["per_layer"])
    assert any("mfu" in m["name"].split("_") for m in SPEC["per_layer"])


def test_cells_and_configs_use_each_other():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_files(entry):
    assert entry["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    cfg = S.config(ROOT, SPEC, entry["name"])
    assert cfg["name"] == entry["name"]
    assert len(entry["reduced"]) <= 16
    assert not [k for k in entry["reduced"] if WIDTH_KEYS.match(k)]
    for role in S.MODEL_ROLES:
        assert S.MODEL_PATH.match(cfg[role]), (role, cfg[role])
        assert (ROOT / cfg[role]).exists()
    assert set(cfg["correct"]) == {"err_ratio"}


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_named_file_is_found(cell):
    assert S.traffic(ROOT, cell["traffic"])["loop"] in ("closed", "open")
    for group in ("end_to_end", "per_layer"):
        for m in SPEC[group]:
            assert callable(S.metric_reader(ROOT, m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_published_sizes(name):
    """Each configuration's published sizes are what its own reference
    counts: parameters per network and model FLOPs per ray. The NeRF
    configurations: 595,844 and 2 x 593,408 weights x 256 samples."""
    cfg = S.config(ROOT, SPEC, name)
    ref = S.model_module(ROOT, cfg, "reference")
    assert ref.param_count(cfg) == cfg["params_per_network"]
    assert ref.flops_per_ray(cfg) == cfg["flops_per_ray"]
    if cfg["reference"] == "bench/reference/nerf.py":
        assert cfg["params_per_network"] == 595844
        assert cfg["flops_per_ray"] == 2 * 593408 * 256 == 303824896
        assert ref.weight_count(cfg) == 593408


#: the counts of the parent commit 2bfbd91 (``bench/work.py`` there):
#: FLOPs per ray, samples per ray, ``launch_bytes(cfg, 4096)``
PARENT_COUNTS = {"nerf-icarus-f32": (303824896, 256, 5012512),
                 "nerf-icarus-rmcm": (303824896, 256, 2641440)}


@pytest.mark.parametrize("name", sorted(PARENT_COUNTS))
def test_counts_equal_the_parents(name):
    """The work counts moved into the reference read as before."""
    cfg = S.config(ROOT, SPEC, name)
    ref = S.model_module(ROOT, cfg, "reference")
    assert (ref.flops_per_ray(cfg), ref.samples_per_ray(cfg),
            ref.launch_bytes(cfg, 4096)) == PARENT_COUNTS[name]


#: sha256 (first 16 hex digits) of each scene's drawn networks on the CPU,
#: layer by layer (name, w, b), for seeds 0 to 2 and scenes 0 to 3, from
#: ``bench/scenes.py``'s ``draw`` of the parent commit 2bfbd91 at full
#: width (the same for the float32 and RMCM configurations)
PARENT_DRAWS = (
    ("bdc7bfd3e61d362a", "9f066f0884b12b05", "a6310d1b33121ed8",
     "d17c4b6bfad3dd32"),
    ("f9fb6407e517b5b4", "9cdcfcbc76214554", "e705a5e2a746439b",
     "cd7ede03ba703139"),
    ("d9a18a58dab44d35", "4a744528dd848f03", "81c4598baeeef6ea",
     "80b991bd8fa3a2da"))


def _digest(nets: dict) -> str:
    h = hashlib.sha256()
    for net in ("coarse", "fine"):
        for name, (w, b) in nets[net].items():
            h.update(name.encode())
            h.update(w.contiguous().numpy().tobytes())
            h.update(b.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", ["nerf-icarus-f32", "nerf-icarus-rmcm"])
def test_draws_equal_the_parents(name):
    """Every scene's weights are bitwise those the parent drew."""
    cfg = S.config(ROOT, SPEC, name)
    ref = S.model_module(ROOT, cfg, "reference")
    got = tuple(tuple(_digest(ref.draw(cfg, seed, scene, "cpu"))
                      for scene in range(4)) for seed in range(3))
    assert got == PARENT_DRAWS


_WRAPPED_REFERENCE = """
from bench.reference import nerf

CALLS = []


def _recorded(name):
    fn = getattr(nerf, name)

    def call(*args, **kwargs):
        CALLS.append(name)
        return fn(*args, **kwargs)
    return call


for _name in ("draw", "pixel_rays", "served_weights", "render",
              "param_count", "flops_per_ray", "samples_per_ray",
              "launch_bytes"):
    globals()[_name] = _recorded(_name)
"""

_WRAPPED_SYSTEM = """
from bench import system as nerf

CALLS = []
KERNELS = nerf.KERNELS
HOST_RANGES = nerf.HOST_RANGES
build_seconds = nerf.build_seconds


def request(view):
    CALLS.append("request")
    return nerf.request(view)


class System(nerf.System):
    def __init__(self, *args, **kwargs):
        CALLS.append("System")
        super().__init__(*args, **kwargs)
"""


def _tree(path):
    return {str(f.relative_to(path)): (f.stat().st_mtime_ns,
                                       hashlib.sha256(f.read_bytes())
                                       .hexdigest())
            for f in sorted(path.rglob("*"))
            if f.is_file() and "__pycache__" not in f.parts}


def test_new_files_are_found_without_editing(tmp_path):
    """A configuration, a traffic mix and a metric added as new files, with
    new entries in ``BENCHMARK.json``, are found by name; so is a model
    whose reference and system modules exist only as new files: a run of
    its cell on the CPU goes through them, and no file of the benchmark's
    tree changes."""
    before = _tree(cells.BENCH)
    model = "bench/models/wrapped"
    cfg = cells.config("f32", reference=f"{model}/reference.py",
                       system=f"{model}/system.py")
    root, spec = cells.make_root(tmp_path, {
        "new-cell": (cells.config("f32"), cells.traffic("closed")),
        "new-model": (cfg, cells.traffic("closed", scenes=1))})
    (root / model).mkdir(parents=True)
    (root / model / "reference.py").write_text(_WRAPPED_REFERENCE)
    (root / model / "system.py").write_text(_WRAPPED_SYSTEM)
    (root / "bench" / "metrics" / "new_metric.v2.py").write_text(
        "def read(run):\n    return 2.5 * run.window_s\n")
    spec["per_layer"].append({"name": "new_metric.v2", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "render step", "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    spec = S.load(root)
    assert S.workload(spec, "new-cell")["config"] == "new-cell"
    assert S.config(root, spec, "new-cell")["trunk_width"] == 64
    assert S.traffic(root, "new-cell")["clients"] == 2
    run = type("Run", (), {"window_s": 2.0})()
    assert S.read_metric(root, "new_metric.v2", run) == 5.0
    names = [m["name"] for m in S.cell_metrics(spec, "new-cell", True)]
    assert "new_metric.v2" in names

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = harness.run_cell(root, spec, S.workload(spec, "new-model"),
                             2 ** 31 + 3, 0.3, False, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert r["correct"], r["compared"]
    cfg = S.config(root, spec, "new-model")
    ref = S.model_module(root, cfg, "reference")
    program = S.model_module(root, cfg, "system")
    assert ref.__file__ == str((root / model / "reference.py").resolve())
    assert {"draw", "pixel_rays", "served_weights", "render"} <= set(
        ref.CALLS)
    assert program.CALLS[0] == "System" and "request" in program.CALLS
    assert _tree(cells.BENCH) == before


def test_model_modules_are_paths_under_bench(tmp_path):
    cfg = {"name": "x", "reference": "bench/../../x.py", "system": 3}
    for role in S.MODEL_ROLES:
        with pytest.raises(ValueError):
            S.model_module(tmp_path, cfg, role)
    with pytest.raises(ValueError):
        S.model_module(tmp_path, cfg, "weights")
    with pytest.raises(FileNotFoundError):
        S.model_module(tmp_path, {"reference": "bench/none.py"}, "reference")


def test_run_seconds_fits_the_check():
    """A full check of 24 cells at ``run_seconds`` fits its budget."""
    runs = 2 + 14 * 24
    need = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200 and math.isfinite(need)
