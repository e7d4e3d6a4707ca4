"""The reduction of a profiler trace to the device's busy time, its
operations, K2's launches and the idle gaps by host span."""
import json
import random

import pytest

from bench import devtrace

KERNELS = {"plcore_two_pass": "plcore_two_pass_kernel"}
HOST = ("engine.submit", "scheduler.next_tile", "plcore.dispatch",
        "executor.drain", "completion.scatter", "loop.sleep")


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def test_reduce(tmp_path):
    # engine clock 100.0 s is the mark at ts 1_000_000 us; window 100.5..101.5
    events = [
        _ev(devtrace.MARK, "user_annotation", 1_000_000, 0),
        _ev("void plcore_two_pass_kernel<256>(Net)", "kernel",
            1_400_000, 200_000),                       # half in the window
        _ev("void plcore_two_pass_kernel<256>(Net)", "kernel",
            1_700_000, 300_000),
        _ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1_750_000,
            100_000),                                  # overlaps the kernel
        _ev("completion.scatter", "user_annotation", 1_600_000, 100_000),
        _ev("executor.drain", "user_annotation", 1_550_000, 200_000),
        _ev("engine.submit", "user_annotation", 2_050_000, 400_000),
        _ev("aten::empty", "cpu_op", 1_600_000, 10),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = devtrace.reduce(str(path), 100.0, 100.5, 101.5, KERNELS, HOST)
    assert r["window_s"] == pytest.approx(1.0)
    # busy: 1.5..1.6 and 1.7..2.0 (the copy inside the kernel)
    assert r["busy_s"] == pytest.approx(0.4)
    assert r["kernel_s"]["plcore_two_pass"] == pytest.approx([0.2, 0.3])
    ops = dict(devtrace.top(r["device_ops"]))
    assert ops["Memcpy HtoD (Pinned -> Device)"] == pytest.approx(0.1)
    idle = r["idle_by_host"]
    # gaps: 1.6..1.7 (scatter inside drain: the innermost), 2.0..2.5
    assert idle["completion.scatter"] == pytest.approx(0.1)
    assert idle["engine.submit"] == pytest.approx(0.5)
    assert sum(idle.values()) == pytest.approx(0.6)


def test_short_names():
    assert devtrace.short(
        "void (anonymous namespace)::plcore_two_pass_kernel<256, 128, true, "
        "true>((anonymous namespace)::Net, int, float const*)") == (
        "plcore_two_pass_kernel<256, 128, true, true>")
    name = "Memcpy HtoD (Pinned -> Device)"
    assert devtrace.short(name) == name


def test_reduce_needs_the_mark(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(RuntimeError):
        devtrace.reduce(str(path), 0.0, 0.0, 1.0, KERNELS, HOST)


def _scan(path, mark_clock, t0, t1, host):
    """The idle gaps by host range as the parent commit 2bfbd91 read them:
    every range scanned for every gap (the oracle of the sweep)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    marks = [e for e in events if e.get("name") == devtrace.MARK]
    base = float(marks[0]["ts"]) - mark_clock * 1e6
    w0, w1 = base + t0 * 1e6, base + t1 * 1e6
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e["name"]) for e in events
           if e.get("cat") in devtrace.DEVICE_CATS]
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in dev
              if b > w0 and a < w1]
    busy = devtrace._union([(a, b) for a, b, _ in inside])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e["name"]) for e in events if e.get("name") in host]
    idle = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        name = min(open_)[1] if open_ else "none"
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return idle


def _synthetic(seed):
    """A trace on a grid of 10 us, so that ranges nest, repeat, abut and
    end exactly at a gap's middle: device operations, some overlapping,
    and host ranges of the listed names and of others."""
    rng = random.Random(seed)
    ev = [_ev(devtrace.MARK, "user_annotation", 0, 0)]
    t = 0
    for _ in range(300):
        t += 10 * rng.randint(0, 4)
        ev.append(_ev(rng.choice(["k1", "k2", "Memcpy HtoD"]),
                      rng.choice(devtrace.DEVICE_CATS), t,
                      10 * rng.randint(0, 6)))
    names = list(HOST) + ["other.range"]
    for _ in range(400):
        s = 10 * rng.randint(-5, t // 10 + 5)
        d = 10 * rng.randint(0, 30)
        ev.append(_ev(rng.choice(names), "user_annotation", s, d))
        if rng.random() < 0.2:          # the same range twice, or nested
            ev.append(_ev(rng.choice(names), "user_annotation", s, d))
        if rng.random() < 0.2:          # abutting: starts where it ends
            ev.append(_ev(rng.choice(names), "user_annotation", s + d,
                          10 * rng.randint(0, 10)))
    rng.shuffle(ev)
    return ev, t


@pytest.mark.parametrize("seed", range(8))
def test_sweep_equals_the_scan(tmp_path, seed):
    """The sweep's idle gaps by host range equal the old scan's exactly,
    ties included (the least length, then the least name)."""
    events, end = _synthetic(seed)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t0, t1 = 25e-6, (end - 15) * 1e-6
    r = devtrace.reduce(str(path), 0.0, t0, t1, KERNELS, HOST)
    want = _scan(str(path), 0.0, t0, t1, HOST)
    assert len(want) >= 3
    assert r["idle_by_host"] == want
    assert list(r["idle_by_host"]) == list(want)
