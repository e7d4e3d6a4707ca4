"""The port's serve CLI, ``--mode nerf`` and ``--mode engine``, on the CPU
at tiny size."""
import numpy as np
import pytest

from repro_torch.launch import serve


def _read_ppm(path):
    magic, size, maxval, body = open(path, "rb").read().split(b"\n", 3)
    assert magic == b"P6" and maxval == b"255"
    w, h = map(int, size.split())
    return np.frombuffer(body, np.uint8).reshape(h, w, 3)


def test_serve_views_through_fused_path(tmp_path):
    stats = serve.main(["--mode", "nerf", "--device", "cpu", "--views", "2",
                        "--kernel", "--fuse-two-pass", "--hw", "12",
                        "--out", str(tmp_path)])
    assert stats["weight_packs_since_load"] == 0
    assert stats["pipeline"] == "two_pass_fused"
    assert len(stats["views"]) == 2
    for v in stats["views"]:
        img = _read_ppm(v["image"])
        assert img.shape == (12, 12, 3)
        assert img.std() > 0 and v["finite"]


def _engine_argv(*extra):
    return ["--mode", "engine", "--device", "cpu", "--kernel",
            "--fuse-two-pass", "--scenes", "3", "--requests", "8",
            "--hw-mix", "8,12", "--loop", "closed", "--concurrency", "4",
            "--pipeline-depth", "2", "--tile-rays", "64", "--check", *extra]


def test_serve_engine_check_clean():
    rep = serve.main(_engine_argv())
    assert rep["device"] == "cpu" and rep["pipeline_depth"] == 2
    assert rep["requests_completed"] == rep["requests_delivered"] == 8
    assert rep["engine"]["max_in_flight"] == 2
    rb = rep["robustness"]
    assert rb["dispatch_errors"] == rb["tile_retries"] == 0
    assert rb["oracle_fallbacks"] == 0
    assert rep["check_compared"] == {"depth1": 8}


def test_serve_engine_trace_out_holds_the_layer_ranges(tmp_path):
    """``--trace-out``: the written trace holds the engine's five layer
    ranges beside the tile chain, the integrity gate passes with them, and
    the report's K2 phase share is None on the CPU."""
    import json
    path = tmp_path / "trace.json"
    rep = serve.main(_engine_argv("--trace-out", str(path)))
    obs = rep["observability"]
    assert obs["integrity"]["ok"] and obs["chrome_integrity"]["ok"]
    assert obs["plcore_two_pass_phase_share"] is None
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]}
    assert {"engine.submit", "scheduler.next_tile", "plcore.dispatch",
            "executor.drain", "completion.scatter"} <= names


def test_serve_engine_check_under_chaos():
    """Every recovery that a tile's result or a scene load triggered traces
    back to an injected fault, and the check held the ok images against a
    clean rerun and a depth-1 rerun. Straggler redispatches are not held
    to the injected straggles: the monitor times tiles on the wall clock,
    so a tile slowed by a loaded host is redispatched too."""
    rep = serve.main(_engine_argv("--inject-faults", "--requests", "12"))
    rb = rep["robustness"]
    inj = rb["faults_injected"]["injected"]
    assert rb["faults_injected"]["total_injected"] > 0
    assert rb["goodput"] >= 0.75
    assert rb["dispatch_errors"] == inj["dispatch_error"]
    assert rb["corrupt_tiles"] <= inj["corrupt"]
    assert rb["scene_load_errors"] == inj["loader_error"]
    assert set(rep["check_compared"]) == {"clean", "depth1"}


def test_serve_engine_check_fails_when_pipelining_never_engages():
    with pytest.raises(SystemExit, match="never had 2 tiles"):
        serve.main(_engine_argv("--concurrency", "1", "--requests", "2",
                                "--hw-mix", "8"))


def test_serve_engine_check_adaptive_sampling():
    """``--adaptive-sampling --scene-bias -0.5``: the check passes its
    adaptive gates (an adaptive tile, memo hits, every budget class, the
    adaptive-off rerun at depth 2 equal to depth 1) and the depth-1 rerun
    of the adaptive engine equals the depth-2 run bit for bit."""
    rep = serve.main(_engine_argv("--adaptive-sampling", "--scene-bias",
                                  "-0.5", "--hw-mix", "8,16"))
    sp = rep["sampling"]
    assert rep["adaptive_sampling"] and sp["adaptive_tiles"] >= 1
    assert sp["memo_hits"] > 0 and sp["dead_rays"] > 0
    assert rep["check_compared"] == {"depth1": 8, "adaptive_off": 8}
    for r in sp["scenes"].values():
        assert r["budgets"] == [4, 8, 16]


@pytest.mark.parametrize("extra,msg", [
    ((), "requires --kernel --fuse-two-pass"),
    (("--kernel", "--fuse-two-pass", "--inject-faults"), "--inject-faults"),
    (("--kernel", "--fuse-two-pass", "--degrade-on-overload"),
     "--degrade-on-overload")])
def test_serve_adaptive_sampling_guards(extra, msg):
    with pytest.raises(SystemExit, match=msg):
        serve.main(["--mode", "engine", "--device", "cpu",
                    "--adaptive-sampling", *extra])
