#!/usr/bin/env python3
"""Readings for the limits of `limits/<cell>.json`: one process runs the
cell on each seed in turn (set-up, a window of `--seconds`, the reference)
and reads, beside the program's numbers, the control's: the reference in
the program's place with bfloat16 pair arithmetic, from the same snapshot.

    python3 bench_port/calibrate.py --workload lj-melt.1m --seconds 2 \
        --seeds 11,12,13 --control 3

Prints one JSON line per seed; `--control k` reads the control on the
first k seeds only. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    sys.path.insert(0, str(REPO))
    from bench_port import decks, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = decks.load_cell(harness.BENCH, args.workload)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                               time.perf_counter(), control=k < args.control)
        out = {"workload": args.workload, "seed": seed,
               "correct": res["correct"],
               "numbers": {n: c["value"] for n, c in res["checks"].items()},
               "control": res["info"].get("control"),
               "reference_s": res["info"].get("reference_s"),
               "window": res["info"]["window"]}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
