"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding what it names by file."""
import json
import math
import re

import pytest

from bench import spec as S, work
from bench.reference import nerf as ref
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
    assert (ROOT / cfg["reference"]).exists()
    assert set(cfg["correct"]) == {"err_ratio"}


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_named_file_is_found(cell):
    assert S.traffic(ROOT, cell["traffic"])["loop"] in ("closed", "open")
    for group in ("end_to_end", "per_layer"):
        for m in SPEC[group]:
            assert callable(S.metric_reader(ROOT, m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_published_sizes(name):
    """Published widths: 595,844 parameters per network and 303,824,896
    model FLOPs per ray."""
    cfg = S.config(ROOT, SPEC, name)
    assert ref.param_count(cfg) == cfg["params_per_network"] == 595844
    assert ref.weight_count(cfg) == 593408
    assert work.flops_per_ray(cfg) == 2 * 593408 * 256 == 303824896
    assert work.samples_per_ray(cfg) == 256


def test_new_files_are_found_without_editing(tmp_path):
    """A configuration, a traffic mix and a metric added as new files, with
    new entries in ``BENCHMARK.json``, are found by name."""
    root, spec = cells.make_root(tmp_path, {"new-cell": (
        cells.config("f32"), cells.traffic("closed"))})
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


def test_run_seconds_fits_the_check():
    """A full check of 24 cells at ``run_seconds`` fits its budget."""
    runs = 2 + 14 * 24
    need = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200 and math.isfinite(need)
