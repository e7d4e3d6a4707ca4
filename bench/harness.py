"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

``main`` is the command line (``bench/run.py``); ``run_cell`` is a run
without the look for a card, which the tests drive on the CPU. A run:

1. reads the cell, its configuration and its traffic mix by name, and
   loads the two modules that the configuration names (``spec.
   model_module``): its ``reference`` and its ``system``;
2. draws every scene's weights from the seed with the reference, hands
   them to the system, which loads them all into the engine's cache and
   warms the tile shape up: set-up ends here, and ``setup_s`` counts from
   the process's start;
3. drives the engine for ``--seconds`` with the mix's loop, then waits for
   every view sent in the window (``traffic``); with ``--trace 1`` under
   ``torch.profiler`` and the engine's span tracer;
4. reads the peak of device memory, keeps a sample of the delivered pixels
   and frees the program's state;
5. renders the sample with the reference and compares (``check``);
6. reads each of the cell's metrics with its own reader
   (``bench/metrics/<name>.py``): the end-to-end metrics without a trace,
   the per-layer metrics with one.

The reference module holds the model's equations and what follows from
them, and imports nothing of the program:

* ``draw(cfg, seed, scene, device)``: one scene's input, drawn on the
  device (``scenes.generator``);
* ``pixel_rays(theta, phi, radius, hw, pixels)``: a tuple of per-pixel
  arrays, which ``check`` joins view by view and hands to ``render``;
* ``served_weights(cfg, drawn)`` and ``render(cfg, served, *rays,
  precision=, block=)``: the pixels, in ``"f64"``, ``"f32"`` and the
  controls' ``"tf32"`` and ``"bf16"``;
* ``param_count(cfg)``, ``flops_per_ray(cfg)``, ``samples_per_ray(cfg)``,
  ``launch_bytes(cfg, rays)``: the counts the metric readers read
  (``run.ref``).

The system module holds the program and is the only module of the
benchmark that imports it:

* ``System(cfg, weights, device, trace)`` with ``engine``, ``residents``,
  ``tracer`` (None untraced), ``warm_up()``, ``resident_bytes()`` and
  ``close()``; ``request(view)``, the engine's request for a view;
* ``KERNELS`` (the device-trace keys of the metric readers -> kernel
  symbols) and ``HOST_RANGES`` (the program's own host ranges, for the
  traced run's idle gaps); ``build_seconds()``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from bench import check, devtrace, spec as S, traffic as T, work

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HOST_THREADS = 4
#: the host range around the open loop's sleep, the harness's own
SLEEP = "loop.sleep"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(root: Path, spec: dict, cell: dict, seed: int, seconds: float,
            trace: bool, device="cuda:0", t_start: float = None,
            plant=None, mix_over: dict = None) -> SimpleNamespace:
    """Steps 1 to 4 of a run: everything up to the check. Returns the run's
    readings (the metric readers' ``run``), with the sampled pixels
    (``picks``), the drawn weights and the views not delivered.
    ``mix_over`` changes parameters of the traffic mix (the rate sweep)."""
    clock = time.perf_counter
    t_start = clock() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = S.config(root, spec, cell["config"])
    mix = {**S.traffic(root, cell["traffic"]), **(mix_over or {})}
    ref = S.model_module(root, cfg, "reference")
    program = S.model_module(root, cfg, "system")
    weights = {i: ref.draw(cfg, seed, i, dev)
               for i in range(int(mix["scenes"]))}
    system = program.System(cfg, weights, dev, trace=trace)
    system.warm_up()
    if plant is not None:
        plant(system)
    engine, tracer = system.engine, system.tracer
    log = T.ScatterLog(engine, clock)
    nvml = None
    if on_card and not trace:
        from bench.energy import Nvml
        nvml = Nvml(dev)
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    stream = T.views(mix, seed)
    sleep = time.sleep
    prof = None
    if trace:
        def sleep(s):
            with torch.profiler.record_function(SLEEP):
                time.sleep(s)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    marks = {}

    def on_open():
        if prof is not None:
            prof.start()
            with torch.profiler.record_function(devtrace.MARK):
                marks["mark"] = clock()
        marks["e0"] = nvml.energy_mj() if nvml else None

    def on_close():
        marks["e1"] = nvml.energy_mj() if nvml else None

    setup_s = clock() - t_start
    if mix["loop"] == "closed":
        win = T.run_closed(engine, program.request, stream,
                           int(mix["clients"]), seconds, clock, on_open,
                           on_close)
    elif mix["loop"] == "open":
        win = T.run_open(engine, program.request, stream,
                         T.arrivals(mix, seed, seconds), seconds, clock,
                         sleep, on_open, on_close)
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    t_end = clock()
    device_summary = None
    if prof is not None:
        if on_card:
            torch.cuda.synchronize(dev)
        prof.stop()
        if on_card:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                t_export = clock()
                prof.export_chrome_trace(path)
                t_reduce = clock()
                device_summary = devtrace.reduce(
                    path, marks["mark"], win.t0, win.t1, program.KERNELS,
                    program.HOST_RANGES + (SLEEP,))
                t_done = clock()
            print(f"bench: trace exported in {t_reduce - t_export} s, "
                  f"reduced in {t_done - t_reduce} s", file=sys.stderr)
        prof = None
    peak_bytes = torch.cuda.max_memory_allocated(dev) if on_card else 0
    resident_bytes = system.resident_bytes()

    done = engine.completed
    lat, queueing, service = [], [], []
    for s in win.sent:
        res = done.get(s.rid)
        if res is not None and res.delivered and s.rid in log.done_at:
            lat.append(log.done_at[s.rid] - s.due)
            queueing.append(res.service_start_s - s.due)
            service.append(res.complete_s - res.service_start_s)
        else:
            lat.append(t_end - s.due)      # never came: missing the tail
    picks, undelivered = check.pick(win.sent, done, seed)
    dispatch_s, coalesced = [], []
    if tracer is not None:
        for sp in tracer.spans():
            if sp.name == "plcore.dispatch" and win.t0 <= sp.t0 <= win.t1:
                dispatch_s.append(sp.t1 - sp.t0)
            elif sp.name == "tile.coalesce":
                coalesced.append(int(sp.attrs["rays"]))
    system.close()
    system = engine = done = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    power_limit = None
    if nvml is not None:
        power_limit = nvml.power_limit_w()
        nvml.close()
    return SimpleNamespace(
        cfg=cfg, traffic=mix, cell=cell, trace=trace, seconds=seconds,
        seed=seed, kind=kind, on_card=on_card, window_s=win.t1 - win.t0,
        rays_window=log.rays_between(win.t0, win.t1),
        rays_energy=log.rays_between(win.t0, win.t_stop),
        energy_j=(None if marks.get("e0") is None
                  else (marks["e1"] - marks["e0"]) / 1e3),
        latencies_s=lat, queueing_s=queueing, service_s=service,
        late_s=[s.sent - s.due for s in win.sent],
        setup_s=setup_s, stats0=win.stats0, stats1=win.stats1,
        dispatch_s=dispatch_s, coalesced_rays=coalesced,
        device=device_summary, peak=work.peaks(kind),
        peak_bytes=peak_bytes, resident_bytes=resident_bytes,
        power_limit_w=power_limit, attempted=len(win.sent),
        backlog_at_close=sum(1 for s in win.sent
                             if log.done_at.get(s.rid, float("inf"))
                             > win.t1),
        undelivered=undelivered, picks=picks, weights=weights, ref=ref)


def run_cell(root: Path, spec: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device="cuda:0", t_start: float = None,
             plant=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``plant``
    (tests) may change the system after set-up, before the window."""
    run = measure(root, spec, cell, seed, seconds, trace, device, t_start,
                  plant)
    numbers = check.judge(run.ref, run.cfg, run.picks, run.weights)
    compared = check.compared(run.cfg, run.undelivered, numbers)
    correct = check.verdict(compared) and bool(run.picks)
    metrics = {}
    for m in S.cell_metrics(spec, cell["name"], trace):
        value = S.read_metric(root, m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_block = {"platform": "gpu" if run.on_card else "cpu",
                 "kind": run.kind, "count": int(cell["chips"]),
                 "memory_peak_bytes": int(run.peak_bytes),
                 "resident_scene_bytes": int(run.resident_bytes)}
    if run.power_limit_w is not None:
        dev_block["power_limit_w"] = run.power_limit_w
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.undelivered, "metrics": metrics,
              "device": dev_block}
    if run.device is not None:
        dev_block["busy_s"] = run.device["busy_s"]
        dev_block["window_s"] = run.device["window_s"]
        result["breakdown"] = {
            "device_ops": devtrace.top(run.device["device_ops"]),
            "idle_gaps": devtrace.top(run.device["idle_by_host"])}
    if run.traffic["loop"] == "open":
        result["generator_late_ms"] = {
            "p50": 1e3 * (T.nearest_rank(run.late_s, 0.5) or 0.0),
            "max": 1e3 * max(run.late_s, default=0.0)}
    result["gaps"] = {k: numbers[k] for k in ("err_mean", "err_mean_f32",
                                               "err_max")}
    result["compared"] = compared
    return result


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float, root: Path) -> int:
    args = parse(argv)
    spec = S.load(root)
    cell = S.workload(spec, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"bench: the cell {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); this machine has {cards}", file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)
    result = run_cell(root, spec, cell, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", t_start)
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}", file=sys.stderr)
        return 3
    program = S.model_module(root, S.config(root, spec, cell["config"]),
                             "system")
    print(f"bench: {result['device']['kind']}, kernel library built in this "
          f"run: {program.build_seconds()} s", file=sys.stderr)
    if "generator_late_ms" in result:
        print(f"bench: generator late {result['generator_late_ms']}",
              file=sys.stderr)
    print(f"bench: gaps to the float64 reference {result['gaps']}",
          file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
