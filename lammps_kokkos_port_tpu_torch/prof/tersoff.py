"""Device time of the Tersoff kernels at the deck's sizes, on the card.

    python -m lammps_kokkos_port_tpu_torch.prof.tersoff --out <file>

For bench/POTENTIALS/in.tersoff at its published 32,000 atoms and at the
scaled 1,024,000 (-var x 4 -var y 2 -var z 4), in float32 and float64: the
sorted state after setup with positions jittered by a seeded +-0.1 A;
`tersoff_short`, `tersoff_force` and `tersoff_force_tally` timed by their
kernels' own device time in torch.profiler traces (the median of ROUNDS
traces of INNER calls; the wrappers' zero fills are not counted). Prints
one JSON line a case, with the counts the roofline needs (atoms, pairs
within R + D, ordered triplets) and ptxas's registers; `--out` also writes
them as a JSON list. chip_smoke.py holds the kernels against their plain
twins at the same sizes.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from ..ops import tersoff_kernels as tk
from ..script import LammpsScript
from . import redesign
from .timing import say

CONFIGS = Path(__file__).resolve().parents[2] / "bench_port" / "configs"
SIZES = {"32k": (1, 1, 1), "1m": (4, 2, 4)}
ROUNDS = 3
INNER = 20


def deck_sim(dtype, size: str, device="cuda"):
    """The deck's Simulation after setup (its `run 0`), at a size of
    SIZES."""
    text = (CONFIGS / "tersoff-si.in").read_text().replace(
        "Si.tersoff", str(CONFIGS / "Si.tersoff"))
    nx, ny, nz = SIZES[size]
    script = LammpsScript(dtype=dtype, device=device, list_mode="sorted",
                          var_overrides={"x": str(nx), "y": str(ny),
                                         "z": str(nz)})
    for line in text.splitlines():
        if not line.startswith("run"):
            script.one(line)
    script.one("run 0")
    return script.sim


def kernel_ms(fn, kernel: str) -> float:
    """The median over ROUNDS traces of `kernel`'s device time per call in
    INNER calls of fn (by its kernel name), each trace taken after a
    warm-up step of INNER calls with the profiler on (redesign.trace's
    schedule). A trace that lost some of the calls' records is taken
    again, up to redesign.TRACE_ATTEMPTS times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def traced() -> list:
        sel = []

        def keep(prof):
            sel.extend(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and f"{kernel}_kernel" in e.name)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=keep) as prof:
            for _ in range(2):
                for _ in range(INNER):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        return sel

    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(ROUNDS):
        for attempt in range(redesign.TRACE_ATTEMPTS):
            sel = traced()
            if len(sel) == INNER:
                got.append(sum(sel) / INNER / 1e3)
                break
            say(f"[device_ms] a trace of {kernel} holds {len(sel)} of "
                f"{INNER} calls (attempt {attempt + 1})")
        else:
            raise RuntimeError(f"no complete trace of {kernel}")
    return statistics.median(got)


def case(size: str, dtype) -> dict:
    t0 = time.perf_counter()
    sim = deck_sim(dtype, size)
    setup_s = time.perf_counter() - t0
    style, p = sim.pair_style, sim.nl.params
    x = redesign.jittered(sim, dtype, 0.1).contiguous()
    mask, prd = sim.state.mask, sim.state.box.prd.to(dtype)
    cutsq = style.max_cutoff() ** 2
    par = style.kernel_params()
    overflow = torch.zeros((), dtype=torch.bool, device=x.device)
    need = torch.zeros((), dtype=torch.int32, device=x.device)
    short, nshort = tk.tersoff_short(cutsq, p.ncells, x, mask, prd, 16,
                                     overflow, need)
    if bool(overflow):
        raise RuntimeError(f"{size}: a short list is longer than 16")
    n = nshort.long()
    out = {"size": size, "dtype": str(dtype).split(".")[-1],
           "grid": list(p.ncells), "cell_cap": p.cell_cap,
           "rows": x.shape[0], "atoms": sim.state.nlocal,
           "pairs": int(n.sum()) // 2, "triplets": int((n * (n - 1)).sum()),
           "setup_s": setup_s}
    calls = {
        "tersoff_short": lambda: tk.tersoff_short(
            cutsq, p.ncells, x, mask, prd, 16, overflow, need),
        "tersoff_force": lambda: tk.tersoff_force(par, x, short, nshort,
                                                  prd),
        "tersoff_force_tally": lambda: tk.tersoff_force_tally(
            par, x, short, nshort, prd)}
    out["device_ms"] = {k: kernel_ms(fn, k) for k, fn in calls.items()}
    del sim
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--sizes", default="32k,1m")
    args = ap.parse_args(argv)
    say(f"[card] {redesign.card()}")
    tk._library()
    say(f"[registers] ptxas, per kernel in build order: "
        f"{redesign.registers(tk.SOURCE)}")
    results = []
    for size in args.sizes.split(","):
        for dtype in (torch.float32, torch.float64):
            res = case(size, dtype)
            say(json.dumps(res))
            results.append(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
