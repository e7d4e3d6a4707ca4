"""The reduction of a profiler trace to the device's busy time, its
operations, K2's launches and the idle gaps by host span."""
import json

import pytest

from bench import devtrace


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
    r = devtrace.reduce(str(path), 100.0, 100.5, 101.5)
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
        devtrace.reduce(str(path), 0.0, 0.0, 1.0)
