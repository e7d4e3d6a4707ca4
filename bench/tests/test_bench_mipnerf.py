"""The Mip-NeRF configuration of the benchmark on the CPU: its reference's
counts and imports, and a run of its cell at tiny() widths that comes out
``correct``, traced and untraced."""
from __future__ import annotations

import ast
import json

import pytest

from bench import harness, spec as S
from bench.tests import cells

SPEC = S.load(cells.ROOT)
NAME = "mipnerf-icarus-f32"
CELL = "mipnerf-f32-view800-closed"
#: MipNerfConfig.tiny()'s widths (the port's card tests use them too)
TINY = {"trunk_layers": 4, "trunk_width": 64, "skip_at": [2],
        "color_width": 32, "max_deg_point": 8, "deg_view": 2,
        "n_samples": 16}


def _config(**over) -> dict:
    cfg = S.config(cells.ROOT, SPEC, NAME)
    cfg.update(TINY)
    cfg.update(tile_rays=64, cache_mb=64)
    cfg.update(over)
    return cfg


def test_counts_of_the_published_config():
    """612,740 parameters, 2 x 610,304 weights x 256 evaluations a ray, 256
    samples, and at 4,096 rays 4,096 x (28 + 36) bytes plus one network's
    2,450,960."""
    cfg = S.config(cells.ROOT, SPEC, NAME)
    ref = S.model_module(cells.ROOT, cfg, "reference")
    assert ref.param_count(cfg) == 612740
    assert ref.weight_count(cfg) == 610304
    assert ref.flops_per_ray(cfg) == 2 * 610304 * 256 == 312475648
    assert ref.samples_per_ray(cfg) == 256
    assert ref.weight_bytes(cfg) == 2450960
    assert ref.launch_bytes(cfg, 4096) == 4096 * 64 + 2450960 == 2713104


def test_the_reference_imports_no_program():
    """The reference imports neither JAX nor either package: torch, numpy,
    the benchmark's ``scenes`` and the NeRF reference only."""
    tree = ast.parse((cells.ROOT / "bench" / "reference"
                      / "mipnerf.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names <= {"__future__", "math", "typing", "numpy", "torch",
                     "bench", "bench.reference.nerf"}, names


def test_the_cell_is_in_the_benchmark():
    cell = S.workload(SPEC, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        NAME, "view800-closed", 1)
    e2e = {m["name"] for m in S.cell_metrics(SPEC, CELL, False)}
    assert {"rays_per_s", "uj_per_sample", "setup_s"} <= e2e
    per_layer = {m["name"] for m in S.cell_metrics(SPEC, CELL, True)}
    assert {"plcore_two_pass_roofline", "plcore_two_pass_encode_pct",
            "plcore_two_pass_row_fill_pct"} <= per_layer


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(tmp_path, trace):
    """A 1-second run of the cell's loop at tiny() widths on the CPU:
    every view delivered, ``err_ratio`` under the configuration's limit,
    the readers of the cell's metrics reading without raising."""
    root, spec = cells.make_root(tmp_path, {"mip": (_config(),
                                                    cells.traffic())})
    result = harness.run_cell(root, spec, spec["workloads"][0], 4100000007,
                              1.0, trace, device="cpu")
    assert result["correct"], json.dumps(result["compared"])
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["compared"]["err_ratio"]["value"] < 10.0
    if not trace:       # a loaded CPU may scatter nothing in 1 s: no value test
        assert {"rays_per_s", "setup_s"} <= set(result["metrics"])
