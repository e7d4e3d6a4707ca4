"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root. The cells, metrics and bounds are in
``BENCHMARK.json``; ``bench/harness.py`` says what a run does. The last
line of standard output is the run's result as one JSON object.
"""
import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
