"""Small cells on the CPU for the benchmark's tests: a copy of the
benchmark's tree in a temporary root, with configurations cut to the
port's ``tiny()`` widths (or kept at full width) and small views."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT / "src") not in sys.path:
    sys.path.append(str(ROOT / "src"))     # the port, as bench/run.py does
TINY = {"trunk_layers": 4, "trunk_width": 64, "skip_at": [2],
        "color_width": 32, "pos_freqs": 6, "dir_freqs": 3, "n_coarse": 16,
        "n_fine": 16}


def config(weights: str = "f32", tiny: bool = True, **over) -> dict:
    name = "nerf-icarus-f32" if weights == "f32" else "nerf-icarus-rmcm"
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    if tiny:
        cfg.update(TINY)
    cfg.update(tile_rays=64, cache_mb=64)
    cfg.update(over)
    return cfg


def traffic(loop: str = "closed", **over) -> dict:
    mix = {"loop": loop, "hw": [8, 12], "scenes": 2, "zipf_s": 1.1,
           "theta": [0.0, 360.0], "phi": [-35.0, -15.0], "radius": 4.0}
    mix.update({"clients": 2} if loop == "closed" else {"rate_rps": 20.0})
    mix.update(over)
    return mix


def make_root(tmp: Path, cells: dict) -> tuple:
    """A root holding the benchmark's metrics, one configuration and one
    traffic file per cell (``cells`` name -> (config dict, traffic dict)),
    and the model modules that the configurations name where the
    benchmark has them. Returns (root, spec)."""
    tmp = Path(tmp)
    shutil.copytree(BENCH / "metrics", tmp / "bench" / "metrics")
    (tmp / "bench" / "configs").mkdir(parents=True)
    (tmp / "bench" / "traffic").mkdir(parents=True)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    for name, (cfg, mix) in cells.items():
        for role in ("reference", "system"):
            src, dst = ROOT / cfg[role], tmp / cfg[role]
            if src.exists() and not dst.exists():
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(src, dst)
        path = f"bench/configs/{name}.json"
        (tmp / path).write_text(json.dumps(cfg))
        (tmp / "bench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
        spec["configs"].append({"name": name, "source": "test",
                                "file": path, "reduced": [], "why": "test"})
        spec["workloads"].append({"name": name, "config": name,
                                  "traffic": name, "chips": 1,
                                  "why": "test"})
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp, spec
