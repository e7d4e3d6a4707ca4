"""The open loop's capacity, found once by a sweep on the card.

    python bench/sweep.py --workload rmcm-mixed-open --rates 6,8,10,12 \\
        --seconds 20 --seed 1 [--out FILE]

Runs the cell's mix at each offered rate, in one process, and prints per
rate the latency tail, how late the sender ran, the views still waiting
when the window closed and the rays delivered per second. The highest
rate that the engine sustains is the highest whose backlog at the close
stays at a few views while its tail does not grow with the window; the
cell's mix runs at about four fifths of it. The benchmark's own runs do
not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness, spec as S  # noqa: E402
from bench.traffic import nearest_rank  # noqa: E402

DEVICE = "cuda:0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    spec = S.load(ROOT)
    cell = S.workload(spec, args.workload)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        run = harness.measure(ROOT, spec, cell, args.seed, args.seconds,
                              False, DEVICE,
                              mix_over={"rate_rps": rate})
        ms = lambda v, q: 1e3 * (nearest_rank(v, q) or 0.0)  # noqa: E731
        row = {"rate_rps": rate, "attempted": run.attempted,
               "undelivered": run.undelivered,
               "backlog_at_close": run.backlog_at_close,
               "latency_p50_ms": ms(run.latencies_s, 0.5),
               "latency_p95_ms": ms(run.latencies_s, 0.95),
               "queueing_p95_ms": ms(run.queueing_s, 0.95),
               "service_p95_ms": ms(run.service_s, 0.95),
               "late_p50_ms": ms(run.late_s, 0.5),
               "late_max_ms": 1e3 * max(run.late_s, default=0.0),
               "rays_per_s": run.rays_window / run.window_s}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
