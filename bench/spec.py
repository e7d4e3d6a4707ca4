"""Where the benchmark finds what ``BENCHMARK.json`` names.

* a cell: an entry of ``workloads``, by its ``name``;
* a configuration: the JSON file that its ``configs`` entry names;
* a traffic mix: ``bench/traffic/<traffic>.json``;
* a metric: the module ``bench/metrics/<metric>.py``, whose ``read(run)``
  returns the metric's value from a finished run, or ``None`` when the run
  holds nothing to read it from;
* a configuration's model: the two modules that its file names by path
  under ``bench/``, ``reference`` (the model's plain equations, its input
  and its counts of work) and ``system`` (the program under test); see
  ``harness`` for what each must hold.

A later cell, mix, metric or model is a new file and a new entry: nothing
here lists them.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Callable, Optional

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
TRAFFIC_DIR = Path("bench") / "traffic"
METRICS_DIR = Path("bench") / "metrics"
MODEL_PATH = re.compile(r"bench/(?:[A-Za-z0-9_][A-Za-z0-9_.\-]*/)*"
                        r"[A-Za-z0-9_][A-Za-z0-9_\-]*\.py\Z")
MODEL_ROLES = ("reference", "system")


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    return _named(spec["workloads"], name, "workload")


def config(root: Path, spec: dict, name: str) -> dict:
    entry = _named(spec["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic(root: Path, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad traffic name {name!r}")
    return json.loads((Path(root) / TRAFFIC_DIR / f"{name}.json").read_text())


def _exec(path: Path, mod_name: str, what: str, keep: bool = False):
    """The module in the file ``path``; with ``keep`` it goes into
    ``sys.modules`` under ``mod_name`` before it runs."""
    module_spec = importlib.util.spec_from_file_location(mod_name, path)
    if module_spec is None or not path.exists():
        raise FileNotFoundError(f"no {what} at {path}")
    module = importlib.util.module_from_spec(module_spec)
    if keep:
        sys.modules[mod_name] = module
    try:
        module_spec.loader.exec_module(module)
    except BaseException:
        if keep:
            del sys.modules[mod_name]
        raise
    return module


def metric_reader(root: Path, name: str) -> Callable:
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = Path(root) / METRICS_DIR / f"{name}.py"
    mod_name = "bench_metric_" + re.sub(r"\W", "_", name)
    return _exec(path, mod_name, f"reader for metric {name!r}").read


def model_module(root: Path, cfg: dict, role: str):
    """The module that the configuration ``cfg`` names under ``role``
    (``reference`` or ``system``), loaded from its path below ``root``.
    A file is loaded once per process: the module stays in
    ``sys.modules`` under a name made from its resolved path."""
    if role not in MODEL_ROLES:
        raise ValueError(f"a configuration names no {role!r} module")
    rel = cfg.get(role)
    if not isinstance(rel, str) or not MODEL_PATH.match(rel):
        raise ValueError(f"the configuration {cfg.get('name')!r} names its "
                         f"{role} module {rel!r}: not a bench/....py path")
    path = (Path(root) / rel).resolve()
    tag = hashlib.sha256(str(path).encode()).hexdigest()[:12]
    stem = re.sub(r"\W", "_", path.stem)
    mod_name = f"bench_{role}_{stem}_{tag}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    return _exec(path, mod_name, f"{role} module", keep=True)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end metrics
    without a trace, its per-layer metrics with one. A metric without a
    ``workloads`` key belongs to every cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(root: Path, name: str, run) -> Optional[float]:
    value = metric_reader(root, name)(run)
    return None if value is None else float(value)
