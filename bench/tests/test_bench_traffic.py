"""The traffic generator, the loops and the metrics' arithmetic."""
import itertools
from collections import Counter
from types import SimpleNamespace

import pytest

from bench import spec as S, traffic as T
from bench.reference import nerf
from bench.tests import cells

MIX = {"loop": "open", "rate_rps": 8.0, "hw": [64, 128, 256], "scenes": 16,
       "zipf_s": 1.1}


def _take(mix, seed, n=256):
    return list(itertools.islice(T.views(mix, seed), n))


def test_views_repeat_by_seed_and_differ_across_seeds():
    big = 2 ** 31 + 12345
    assert _take(MIX, big) == _take(MIX, big)
    assert _take(MIX, big) != _take(MIX, big + 1)


def test_every_seed_gets_the_same_work():
    """Each block of views holds the same sides and scenes whatever the
    seed; only their order and the poses move."""
    counts = set()
    for seed in (1, 2, 2 ** 31 + 7):
        vs = _take(MIX, seed, T.BLOCK * 3)
        counts.add(tuple(sorted(Counter((v.hw, ) for v in vs).items())))
        counts.add(tuple(sorted(Counter(v.scene for v in vs).items())))
    assert len(counts) == 2
    shares = T.scene_shares(MIX)
    assert shares[0] > shares[-1] and abs(shares.sum() - 1) < 1e-12


def test_arrivals_offer_the_same_load_in_another_order():
    a = T.arrivals(MIX, 5, 40.0)
    b = T.arrivals(MIX, 6, 40.0)
    assert a != b and a == T.arrivals(MIX, 5, 40.0)
    def gaps(t):
        return sorted(round(y - x, 9) for x, y in zip([0.0] + t, t))
    assert gaps(a[:T.BLOCK]) == gaps(b[:T.BLOCK])
    assert abs(len(a) - 8.0 * 40.0) <= 8.0 * 40.0 * 0.1
    assert all(0 <= x < 40.0 for x in a)


def test_a_trace_seed_replays_one_schedule_with_the_seeds_poses():
    """With ``trace_seed`` every run seed sends the same sides and scenes
    at the same times; the seed still draws the poses."""
    mix = {**MIX, "trace_seed": 3}
    a, b = _take(mix, 5, T.BLOCK * 2), _take(mix, 2 ** 31 + 6, T.BLOCK * 2)
    assert [(v.scene, v.hw) for v in a] == [(v.scene, v.hw) for v in b]
    assert [v.theta for v in a] != [v.theta for v in b]
    assert a == _take(mix, 5, T.BLOCK * 2)
    assert T.arrivals(mix, 5, 40.0) == T.arrivals(mix, 2 ** 31 + 6, 40.0)
    other = {**MIX, "trace_seed": 4}
    assert T.arrivals(other, 5, 40.0) != T.arrivals(mix, 5, 40.0)
    assert ([(v.scene, v.hw) for v in _take(other, 5, T.BLOCK * 2)]
            != [(v.scene, v.hw) for v in a])


def test_quota_sums_and_rounds():
    q = T.quota(T.scene_shares(MIX), 64)
    assert q.sum() == 64 and (q >= 1).all()
    assert list(T.quota([0.5, 0.5], 3)) in ([2, 1], [1, 2])


def _run(**kw):
    base = dict(cfg=cells.config("f32", tiny=False), window_s=10.0,
                rays_window=0, rays_energy=0, energy_j=None, latencies_s=[],
                queueing_s=[], service_s=[], device=None, peak=None,
                stats0={"padded_rays": 0, "rays_rendered": 0},
                stats1={"padded_rays": 0, "rays_rendered": 0},
                dispatch_s=[], coalesced_rays=[], setup_s=1.0, ref=nerf)
    base.update(kw)
    return SimpleNamespace(**base)


def _read(name, run):
    return S.read_metric(cells.ROOT, name, run)


def test_latency_tail_counts_undelivered_views():
    """A view never delivered counts as the time it was waited for: it
    lies in the tail, it is not dropped from it."""
    lat = [0.1] * 19 + [61.0]
    assert _read("latency_p95_ms", _run(latencies_s=lat)) == 100.0
    lat = [0.1] * 18 + [61.0, 61.0]
    assert _read("latency_p95_ms", _run(latencies_s=lat)) == 61000.0
    assert _read("latency_p50_ms", _run(latencies_s=lat)) == 100.0


def test_rays_per_s_is_over_the_whole_window():
    run = _run(rays_window=1_000_000, window_s=10.0)
    assert _read("rays_per_s", run) == 100_000.0


def test_energy_per_sample():
    run = _run(energy_j=4000.0, rays_energy=1_000_000)
    # 256 samples per ray: 4000 J / 256e6 samples
    assert _read("uj_per_sample", run) == pytest.approx(15.625)
    assert _read("uj_per_sample", _run()) is None


def test_shares_of_peaks_are_never_read_as_zero():
    assert _read("mfu_pct", _run()) is None
    assert _read("plcore_two_pass_roofline", _run()) is None
    assert _read("device_idle_pct", _run()) is None
    peak = {"flops_per_s": 989e12, "bytes_per_s": 3.35e12}
    run = _run(rays_window=1_800_000, window_s=10.0, peak=peak)
    assert _read("mfu_pct", run) == pytest.approx(
        100 * 180_000 * 303824896 / 989e12)
    dev = {"kernel_s": {"plcore_two_pass": [0.02, 0.02]}, "busy_s": 9.0,
           "window_s": 10.0}
    run = _run(device=dev, peak=peak, coalesced_rays=[4096, 1024])
    least = 303824896 * 5120 / 989e12
    assert _read("plcore_two_pass_roofline", run) == pytest.approx(
        100 * least / 0.04, rel=1e-6)
    assert _read("device_idle_pct", run) == pytest.approx(10.0)
    run = _run(device=dev, peak=peak, coalesced_rays=[4096])
    assert _read("plcore_two_pass_roofline", run) is None


def test_padding_and_dispatch():
    run = _run(stats0={"padded_rays": 10, "rays_rendered": 100},
               stats1={"padded_rays": 30, "rays_rendered": 180},
               dispatch_s=[0.001, 0.003])
    assert _read("padded_ray_pct", run) == pytest.approx(20.0)
    assert _read("host_dispatch_ms", run) == pytest.approx(2.0)


class _FakeEngine:
    """A stand-in engine: a view takes ``steps`` steps to complete."""

    def __init__(self, steps=3):
        self.completion = SimpleNamespace(completion_order=[],
                                          scatter=self._scatter)
        self.completed = {}
        self.stats = {"padded_rays": 0, "rays_rendered": 0}
        self.queue = []
        self.steps = steps
        self._rid = 0

    @property
    def pending(self):
        return len(self.queue)

    def submit(self, req):
        self.queue.append([self._rid, self.steps, req])
        self._rid += 1
        return self._rid - 1

    def _scatter(self, tile, rgb):
        self.completion.completion_order.append(tile.rid)
        self.completed[tile.rid] = SimpleNamespace(delivered=True)

    def step(self):
        if not self.queue:
            return False
        self.queue[0][1] -= 1
        if self.queue[0][1] == 0:
            rid = self.queue.pop(0)[0]
            tile = SimpleNamespace(rid=rid, n_real=10)
            self.completion.scatter(tile, None)
        return True


def _clock():
    t = [0.0]

    def clock():
        t[0] += 0.01
        return t[0]
    return clock


def test_closed_loop_window_and_drain():
    eng, clock = _FakeEngine(), _clock()
    log = T.ScatterLog(eng, clock)
    win = T.run_closed(eng, lambda v: v, T.views(MIX, 3), 2, 1.0, clock)
    assert eng.pending == 0 and len(win.sent) >= 2
    assert all(s.rid in log.done_at for s in win.sent)
    assert log.rays_between(win.t0, win.t1) < 10 * len(win.sent)
    assert log.rays_between(0.0, 1e9) == 10 * len(win.sent)


def test_open_loop_sends_when_due_and_drains():
    eng, clock = _FakeEngine(steps=2), _clock()
    log = T.ScatterLog(eng, clock)
    due = T.arrivals(MIX, 4, 2.0)
    win = T.run_open(eng, lambda v: v, T.views(MIX, 4), due, 2.0, clock,
                     sleep=lambda s: None)
    assert len(win.sent) == len(due)
    assert all(s.sent >= s.due for s in win.sent)
    assert all(s.rid in log.done_at for s in win.sent)
    assert win.t_stop >= win.t1
