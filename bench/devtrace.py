"""The device's timeline in a traced run, from ``torch.profiler``.

The run marks its window on the host (``MARK``, a zero-length annotation
at a known time of the engine's clock); the host ranges are named by the
caller (the program's own ranges around its layers, and the harness's
around its sleep), and so are the kernels whose launches are timed.
``reduce`` reads the exported Chrome trace:

* ``busy_s``: the union of the device's operations (kernels, copies,
  sets) inside the window; ``window_s`` its length;
* ``device_ops``: device seconds inside the window by operation name;
* ``kernel_s``: the durations of every launch of each kernel in
  ``kernels``, over the whole trace (window and drain);
* ``idle_by_host``: the window's idle seconds by the innermost host range
  open at each gap's middle: the shortest, the least name among equally
  long ones ("none" where none was open).
"""
from __future__ import annotations

import heapq
import json
from typing import Dict, Iterable, List, Tuple

MARK = "bench.mark"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _idle_by_host(gaps: Iterable[Tuple[float, float]],
                  host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of the gaps (a, b), in order of time, by the least (length,
    name) among the host ranges (start, end, name) that hold each gap's
    middle. One sweep: a range joins a heap when the middles reach its
    start and leaves it once they have passed its end."""
    host = sorted(host)
    idle: Dict[str, float] = {}
    open_: List[Tuple[float, str, float]] = []
    j = 0
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            s, e, n = host[j]
            heapq.heappush(open_, (e - s, n, e))
            j += 1
        while open_ and open_[0][2] < mid:
            heapq.heappop(open_)
        name = open_[0][1] if open_ else "none"
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return idle


def reduce(path: str, mark_clock: float, t0: float, t1: float,
           kernels: Dict[str, str], host: Iterable[str]) -> dict:
    """The device summary of the window [t0, t1] (engine clock, seconds);
    ``mark_clock`` is the engine clock at the ``MARK`` annotation;
    ``kernels``: key -> a kernel's symbol, as the device names its
    launches; ``host``: the names of the host ranges for the idle gaps."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    marks = [e for e in events if e.get("name") == MARK]
    if not marks:
        raise RuntimeError("the trace holds no window mark")
    base = float(marks[0]["ts"]) - mark_clock * 1e6
    w0, w1 = base + t0 * 1e6, base + t1 * 1e6
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e["name"]) for e in events if e.get("cat") in DEVICE_CATS]
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in dev
              if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in inside])
    ops: Dict[str, float] = {}
    for a, b, n in inside:
        ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
    kernel_s = {k: [(b - a) / 1e6 for a, b, n in dev if sym in n]
                for k, sym in kernels.items()}
    names = frozenset(host)
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
               e["name"]) for e in events if e.get("name") in names]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (w1 - w0) / 1e6,
            "device_ops": ops, "kernel_s": kernel_s,
            "idle_by_host": _idle_by_host(zip(edges[0::2], edges[1::2]),
                                          ranges)}


def short(name: str) -> str:
    """A kernel's name without ``void``, the anonymous namespace and the
    parameter list; other operations' names as they are."""
    if not name.startswith("void "):
        return name
    name = name[5:].replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i]
    return name


def top(d: Dict[str, float], n: int = 10) -> list:
    return [[short(k), v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
