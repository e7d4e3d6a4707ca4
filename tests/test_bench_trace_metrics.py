"""The benchmark's readers of the engine's trace block (``bench/metrics``):
K2's phase shares, the host's wait on the card and the backlog at
admission, each from the window's deltas of the engine's stats, and None
when the stats lack the counters (a program without them)."""
from types import SimpleNamespace

import pytest

from bench import spec as S
from bench.tests.cells import ROOT

SHARES = ("mlp", "ring_wait", "resample", "scalar")


def _read(name, stats0, stats1, window_s=2.0):
    run = SimpleNamespace(stats0=stats0, stats1=stats1, window_s=window_s)
    return S.read_metric(ROOT, name, run)


def _cycles(mlp, ring, resample, scalar, total):
    return {f"plcore_two_pass_cycles_{p}": n for p, n in
            zip(SHARES + ("total",), (mlp, ring, resample, scalar, total))}


@pytest.mark.parametrize("phase,want", [("mlp", 42.0), ("ring_wait", 8.0),
                                        ("resample", 15.0),
                                        ("scalar", 30.0)])
def test_phase_share_readers(phase, want):
    """The window's delta of the phase over the window's delta of K2's
    total, in percent: cycles before the window do not count."""
    s0 = _cycles(100, 50, 70, 10, 1000)
    s1 = _cycles(100 + 420, 50 + 80, 70 + 150, 10 + 300, 1000 + 1000)
    name = f"plcore_two_pass_{phase}_pct"
    assert _read(name, s0, s1) == pytest.approx(want)
    # no traced K2 launch in the window, or no counters at all
    assert _read(name, s1, s1) is None
    assert _read(name, {"dispatches": 1}, {"dispatches": 9}) is None


def test_host_wait_pct():
    assert _read("host_wait_pct", {"host_wait_s": 1.0},
                 {"host_wait_s": 2.7}, window_s=2.0) == pytest.approx(85.0)
    assert _read("host_wait_pct", {}, {"padded_rays": 0}) is None


def test_backlog_tiles_mean():
    s0 = {"admitted_views": 3, "backlog_tiles_at_admit": 10}
    s1 = {"admitted_views": 7, "backlog_tiles_at_admit": 10 + 90}
    assert _read("backlog_tiles_mean", s0, s1) == pytest.approx(22.5)
    assert _read("backlog_tiles_mean", s1, s1) is None
    assert _read("backlog_tiles_mean", {}, {"dispatches": 2}) is None


def test_row_fill_pct():
    """The window's real rows over its MMA rows, in percent: 2/3 for lone
    rays at 64 + 128 samples, 100 for pairs; None without a traced K2
    launch in the window or without the counters (the parent)."""
    def rows(mma, real):
        return {"plcore_two_pass_rows_mma": mma,
                "plcore_two_pass_rows_real": real}
    name = "plcore_two_pass_row_fill_pct"
    s0 = rows(3840, 2560)
    assert _read(name, s0, rows(3840 + 384, 2560 + 256)) == pytest.approx(
        200.0 / 3.0)
    assert _read(name, s0, rows(3840 + 512, 2560 + 512)) == pytest.approx(
        100.0)
    assert _read(name, s0, s0) is None
    assert _read(name, _cycles(1, 1, 1, 1, 4), _cycles(2, 2, 2, 2, 8)) is None


def test_overlap_pct():
    """The window's k steps issued with the warpgroup's previous step in
    flight over its k steps, in percent: 141 of every 152 in RMCM's
    pipelined loop, 0 where K2 waits for each step; None without a traced
    K2 launch in the window or without the counters (the parent)."""
    def steps(mma, overlapped):
        return {"plcore_two_pass_steps_mma": mma,
                "plcore_two_pass_steps_overlapped": overlapped}
    name = "plcore_two_pass_overlap_pct"
    s0 = steps(3040, 2820)
    assert _read(name, s0, steps(3040 + 1520, 2820 + 1410)) == pytest.approx(
        100.0 * 141 / 152)
    assert _read(name, s0, steps(3040 + 608, 2820)) == 0.0
    assert _read(name, s0, s0) is None
    assert _read(name, _cycles(1, 1, 1, 1, 4), _cycles(2, 2, 2, 2, 8)) is None


def test_readers_are_declared_where_they_read():
    """Each reader has its ``per_layer`` entry: the closed cells for the
    shares, the host's wait, K2's row fill and its overlapped k steps
    (``rays_per_s``), the open cell for the backlog (``latency_p95_ms``)."""
    spec = S.load(ROOT)
    entry = {m["name"]: m for m in spec["per_layer"]}
    closed = ["f32-view800-closed", "rmcm-view800-closed",
              "rmcm-preview-closed", "mipnerf-f32-view800-closed"]
    for name in [f"plcore_two_pass_{p}_pct" for p in SHARES] + [
            "host_wait_pct", "plcore_two_pass_row_fill_pct",
            "plcore_two_pass_overlap_pct"]:
        assert entry[name]["workloads"] == closed
        assert entry[name]["moves"] == "rays_per_s"
        assert entry[name]["source"] == "program_counter"
    assert entry["backlog_tiles_mean"]["workloads"] == ["rmcm-mixed-open"]
    assert entry["backlog_tiles_mean"]["moves"] == "latency_p95_ms"
