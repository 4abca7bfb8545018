"""The benchmark's command: one cell of BENCHMARK.json on this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. It prints its result as the last line of
standard output (README.md); without a CUDA card, or with fewer cards than
the cell asks for, it prints none and exits non-zero.
"""

import time

T0 = time.perf_counter()       # set-up is timed from the process's start

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    from benchmark.harness.main import cache_env, main

    cache_env(ROOT)
    sys.exit(main(sys.argv[1:], ROOT, T0))
