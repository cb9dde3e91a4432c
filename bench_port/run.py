#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the card.

    python3 bench_port/run.py --workload lj-melt.1m --seed 7 --seconds 10 \
        --trace 0

From the root of a checkout. Prints one JSON result line as the last line
of standard output, and each number compared beside its limit as the last
lines of standard error. Exits 2, printing no result, without enough CUDA
devices.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / ".bench_port_cache"


def main(argv=None) -> int:
    sys.path.insert(0, str(REPO))
    # fixed cache directories inside the checkout, so that only the first
    # run of a cell in a checkout builds
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    from bench_port import harness

    return harness.main(sys.argv[1:] if argv is None else argv, T_START)


if __name__ == "__main__":
    sys.exit(main())
