"""The readings that the limits of ``correct`` are set from, on the card.

    python bench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 8 [--out FILE]

In one process (the kernel library loads once), for each seed: a run of
the cell with a short window at its own load (``harness.measure``), then
the compared numbers of the program (``check.judge``) over the run's
sample of delivered pixels. For each control seed also the control's: the
same pixels by the reference computed a step below the configuration's
precision (``tf32``, and ``bf16`` beside it) in the program's place.
Prints one JSON line per seed and writes them all to ``--out``. The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import check, harness, spec as S  # noqa: E402

CONTROLS = ("tf32", "bf16")
DEVICE = "cuda:0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    spec = S.load(ROOT)
    cell = S.workload(spec, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.perf_counter()
        run = harness.measure(ROOT, spec, cell, seed, args.seconds, False,
                              DEVICE)
        t_ref = time.perf_counter()
        got = np.concatenate([p.got for p in run.picks])
        sample = (run.ref, run.cfg, run.picks, run.weights)
        want = check.render_picks(*sample)
        row = {"workload": cell["name"], "seed": seed,
               "undelivered": run.undelivered, "attempted": run.attempted,
               "pixels": len(got), "views": len(run.picks),
               "program": check.judge(*sample, got, want),
               "reference_s": time.perf_counter() - t_ref}
        if seed in controls:
            for prec in CONTROLS:
                low = check.render_picks(*sample, precision=prec)
                row[prec] = check.judge(*sample, low, want)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
