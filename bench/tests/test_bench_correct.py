"""What decides ``correct``: the reference against the port, and the
harness driven on the CPU with the timed path sound, broken, or replaced
by the control (the reference a step below the configuration's
precision). The look for a card is skipped (``harness.run_cell``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import check, harness, spec as S
from bench.reference import nerf as ref
from bench.tests import cells


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, cfg, mix, plant=None, seed=2 ** 31 + 11, seconds=0.4):
    root, spec = cells.make_root(tmp_path, {"c": (cfg, mix)})
    return harness.run_cell(root, spec, S.workload(spec, "c"), seed,
                            seconds, False, device="cpu", plant=plant)


def _wrap_tiles(system, change):
    """Every resident's tiles pass through ``change(k, o, d, pixels)``
    (k counts the tiles) where they are produced."""
    count = [0]
    for pp in system.residents.values():
        def dispatch(o, d, _orig=pp.dispatch_tile, **kw):
            handle, cost = _orig(o, d, **kw)
            k = count[0]
            count[0] += 1
            arr = change(k, np.asarray(o), np.asarray(d),
                         np.array(handle.result()))
            return type("H", (), {"result": lambda self: arr,
                                  "done": lambda self: True})(), cost
        pp.dispatch_tile = dispatch


@pytest.mark.parametrize("weights", ["f32", "rmcm"])
def test_reference_against_the_engine_at_tiny(tmp_path, weights):
    """The port's engine at ``tiny()`` widths on the CPU (K2's plain
    version) agrees with the reference, through the harness."""
    r = _run(tmp_path, cells.config(weights), cells.traffic("closed"))
    assert r["correct"], r["compared"]
    assert r["compared"]["err_ratio"]["value"] < 3.0
    assert r["attempted"] >= 2 and r["failed"] == 0


def test_open_loop_cell_on_the_cpu(tmp_path):
    r = _run(tmp_path, cells.config("rmcm"), cells.traffic("open"))
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) >= {"latency_p50_ms", "latency_p95_ms",
                                 "setup_s"}
    assert r["device"]["platform"] == "cpu"


def test_rmcm_copy_equals_the_ports_quantization():
    from repro_torch.core import rmcm
    cfg = cells.config("rmcm", tiny=False)
    nets = ref.draw(cfg, 7, 0, "cpu")
    for name, (w, _) in nets["fine"].items():
        ours = ref.rmcm_dequantize(w)
        theirs = rmcm.dequantize(rmcm.quantize(w))
        assert torch.equal(ours, theirs), name


def test_weights_repeat_by_seed_and_scene():
    cfg = cells.config("f32")
    a = ref.draw(cfg, 2 ** 31 + 5, 1, "cpu")["coarse"]["trunk.0"][0]
    b = ref.draw(cfg, 2 ** 31 + 5, 1, "cpu")["coarse"]["trunk.0"][0]
    c = ref.draw(cfg, 2 ** 31 + 5, 2, "cpu")["coarse"]["trunk.0"][0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_pixel_rays_match_the_engines_camera():
    from repro_torch.data import rays as R
    hw, pix = 24, np.array([0, 5, 300, 575])
    o, d = ref.pixel_rays(37.0, -21.0, 4.0, hw, pix)
    ro, rd = R.camera_rays(R.pose_spherical(37.0, -21.0, 4.0), hw, hw,
                           0.9 * hw)
    assert np.abs(rd.reshape(-1, 3)[pix].numpy() - d).max() < 1e-6
    assert np.abs(ro.reshape(-1, 3)[pix].numpy() - o).max() < 1e-5


# --------------------------------------------------- faults and control --
def _altered(k, o, d, px):
    if k == 0:
        px = px.copy()
        px[:, 0] = 1.0 - px[:, 0]       # one tile's answer altered
    return px


def _half_left_out(k, o, d, px):
    px = px.copy()
    h = len(px) // 2
    px[h:2 * h] = px[:h]                # half the tile's rays not rendered
    return px


_first = {}


def _unchanged(k, o, d, px):
    return _first.setdefault("px", px) if k else _first.__setitem__(
        "px", px) or px                 # later tiles return the first's


def _misplaced(system):
    sink = system.engine.completion
    orig = sink.scatter
    sink.scatter = lambda tile, rgb: orig(tile, np.roll(rgb, 1, axis=0))


@pytest.mark.parametrize("fault", ["altered", "half_left_out", "unchanged",
                                   "misplaced"])
def test_faults_come_out_not_correct(tmp_path, fault):
    _first.clear()
    change = {"altered": _altered, "half_left_out": _half_left_out,
              "unchanged": _unchanged}.get(fault)
    plant = (_misplaced if fault == "misplaced"
             else lambda s: _wrap_tiles(s, change))
    r = _run(tmp_path, cells.config("f32"), cells.traffic("closed"), plant)
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("weights", ["f32", "rmcm"])
def test_control_comes_out_not_correct(tmp_path, weights):
    """The reference computed in TF32, put in the program's place, at the
    configuration's widths and limits, fails the comparison."""
    cfg = cells.config(weights, tiny=False, n_coarse=64, n_fine=128)
    mix = cells.traffic("closed", hw=[6], scenes=1, clients=1)

    def plant(system):
        nets = ref.served_weights(cfg, system.weights["scene0"])

        def change(k, o, d, px):
            return ref.render(cfg, nets, o.astype(np.float64),
                              d.astype(np.float64),
                              precision="tf32").numpy()
        _wrap_tiles(system, change)
    r = _run(tmp_path, cfg, mix, plant, seconds=0.2)
    assert not r["correct"], r["compared"]
    assert r["compared"]["undelivered"]["value"] == 0


def test_gaps_and_verdict():
    want = np.zeros((4, 3))
    got = want.copy()
    got[1, 2] = 0.5
    g = check.gaps(got, want)
    assert g["err_max"] == 0.5 and g["err_mean"] == pytest.approx(0.5 / 12)
    cfg = {"correct": {"err_ratio": 3.0}}
    assert check.verdict(check.compared(cfg, 0, {"err_ratio": 2.9}))
    assert not check.verdict(check.compared(cfg, 0, {"err_ratio": 3.1}))
    assert not check.verdict(check.compared(cfg, 1, {"err_ratio": 1.0}))


# ----------------------------------------------------------- processes --
_SNIPPET = """
import json, sys, tempfile, torch
torch.set_num_threads(1)
sys.path[:0] = [{root!r}, {src!r}]
from bench import harness, spec as S
from bench.tests import cells
root, spec = cells.make_root(tempfile.mkdtemp(), {{"c": (
    cells.config("rmcm"), cells.traffic("open"))}})
r = harness.run_cell(root, spec, S.workload(spec, "c"), 3, 0.3, True,
                     device="cpu")
assert r["correct"], r
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_harness_loads_neither_jax_nor_the_jax_package():
    """Importing and running the harness's CPU path, traced, loads no
    module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
    ``repro`` (the port's own name begins with it). In a subprocess: the
    test workers have JAX loaded already."""
    code = _SNIPPET.format(root=str(cells.ROOT), src=str(cells.ROOT / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_no_card_no_result():
    """Without a CUDA device the command fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "f32-view800-closed",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=cells.ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout
