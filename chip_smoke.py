#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's LJ-melt main path (lammps_kokkos_port_tpu_torch) through
the entry points a user calls, and checks it on the card:

  1. device: the card's name and power limit (nvidia-smi); build the CUDA
     pair-force kernel from csrc/ with nvcc;
  2. the kernel against its plain PyTorch version on the card, at the main
     path's grids (32k-atom deck and 1M-atom deck), f32 and f64, with
     positions jittered by a seeded +-0.05 so forces are not lattice zeros;
     max abs error and median CUDA-event times of both;
  3. golden step 0: examples/melt in f64 against the reference's log;
  4. the main path: the 32k-atom bench/in.lj melt in f32, setup() +
     run(1000, thermo_every=100), with the kernel's launch count over that
     run, energy drift and the slope-timed step rate;
  5. the 1M-atom deck (cells=63), f32, 200 steps, same checks.

Every failed check raises (non-zero exit, no result line). The last two
lines are the kernel table and the result, one JSON object each.

Usage, from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

KERNEL_SOURCE = "lammps_kokkos_port_tpu_torch/csrc/lj_cell_force.cu"
# the Pallas kernels it replaces: K1 (32k path), K2 (1M path), K3
REPLACES = "lammps_kokkos_port_tpu/ops/pallas_pair.py:331"
ALSO_REPLACES = ["lammps_kokkos_port_tpu/ops/pallas_pair.py:645",
                 "lammps_kokkos_port_tpu/ops/pallas_pair.py:799"]
SEED = 87287
T_INIT = 1.44


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_vs_plain(sim, dtype, label: str) -> dict:
    """Phase 2 on one grid and dtype."""
    import torch

    from lammps_kokkos_port_tpu_torch.ops.pair_kernels import (
        lj_cell_force, lj_cell_force_reference)

    st, p = sim.state, sim.nl.params
    gen = torch.Generator(device=st.device).manual_seed(SEED)
    jitter = (torch.rand(st.x.shape, generator=gen, device=st.device,
                         dtype=torch.float64) - 0.5) * 0.1
    x = torch.where(st.valid_mask[:, None], st.x.double() + jitter,
                    st.x.double()).to(dtype)
    g = x.t().contiguous().reshape(3, p.total_cells, p.cell_cap)
    prd = st.box.prd.to(dtype)
    key = sim.pair_style.kernel_key()
    args = (key, p.ncells, g[0], g[1], g[2], prd)

    f = lj_cell_force(*args)
    ref = lj_cell_force_reference(*args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(f).all()):
        raise RuntimeError(f"{label}: kernel forces are not finite")
    # tolerances: the two sum the same pair terms in another order (the
    # cutoff decisions are identical: r2 is rounded the same way in both);
    # the atol scaled by max|f| covers rows whose net force cancels
    rtol = 1e-4 if dtype == torch.float32 else 1e-10
    fmax = ref.abs().max().item()
    err = (f - ref).abs()
    bad = int((err > rtol * fmax + rtol * ref.abs()).sum())
    max_abs = err.max().item()
    max_rel = (err / ref.abs().clamp_min(1e-3 * fmax)).max().item()
    ms = cuda_ms(lambda: lj_cell_force(*args), reps=20)
    plain_ms = cuda_ms(lambda: lj_cell_force_reference(*args), reps=5,
                       warmup=1)
    log(f"[kernel] {label}: grid {p.ncells} x cc {p.cell_cap} "
        f"({p.total_cells * p.cell_cap} rows), max|f| {fmax:.6g}, "
        f"max abs err {max_abs:.3e}, max rel err {max_rel:.3e} "
        f"(rtol {rtol:g}, atol {rtol:g}*max|f|), kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    if bad:
        raise RuntimeError(f"{label}: {bad} force components out of "
                           "tolerance")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def check_run(sim, rows, label: str) -> None:
    """Finite thermo (run() already raises otherwise), clear overflow."""
    import math

    for r in rows:
        if not all(math.isfinite(v) for v in r.values()
                   if isinstance(v, float)):
            raise RuntimeError(f"{label}: non-finite thermo {r}")
    if bool(sim.nl.overflow):
        raise RuntimeError(f"{label}: capacity overflow flag set")
    drift = rows[-1]["etotal"] - rows[0]["etotal"]
    log(f"[{label}] etotal step {rows[0]['step']} {rows[0]['etotal']:.7f} "
        f"-> step {rows[-1]['step']} {rows[-1]['etotal']:.7f} "
        f"(drift {drift:.3e} per atom), temp {rows[-1]['temp']:.6f}, "
        f"press {rows[-1]['press']:.6f}")
    # a sanity bound, not a physics claim
    if abs(drift) >= 0.02:
        raise RuntimeError(f"{label}: |etotal drift| {abs(drift)} >= 0.02")


def step_rate(sim, k1: int, label: str, reps: int = 5) -> None:
    """Steady-state ms/step from two segment lengths (k1, 3*k1), so the
    fixed per-segment cost cancels (as bench.py does). The two lengths run
    in turns, `reps` times each, from the same state; the slope is taken
    between their median times (host-clock times of a host-bound loop
    spread more than device times)."""
    import torch

    runner = sim._get_segment_runner()

    def timed(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, nl = runner(sim.state, sim.nl, k)
        ok = bool(torch.isfinite(s.x).all()) and not bool(nl.overflow)
        dt = time.perf_counter() - t0
        if not ok:
            raise RuntimeError(f"{label}: timed segment k={k} unhealthy")
        return dt

    timed(k1)  # warm-up
    t1s, t2s = [], []
    for _ in range(reps):
        t1s.append(timed(k1))
        t2s.append(timed(3 * k1))
    t1, t2 = statistics.median(t1s), statistics.median(t2s)
    per_step = (t2 - t1) / (2 * k1)
    rate = sim.state.nlocal / per_step
    log(f"[{label}] {sim.state.nlocal} atoms: {per_step * 1e3:.4f} ms/step, "
        f"{rate:.6g} atom-steps/s (slope of medians over {reps} runs of "
        f"{k1} and {3 * k1} steps: {t1:.4f} s, {t2:.4f} s; all "
        f"{[round(t, 4) for t in t1s]} / {[round(t, 4) for t in t2s]})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lammps_kokkos_port_tpu_torch.ops import pair_kernels
    from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device + build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_log = pair_kernels.build()
    log(f"[build] nvcc {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    # 2. kernel vs plain at the main path's grids
    t0 = time.perf_counter()
    sim32 = lj_melt_sim(cells=20, t_init=T_INIT, seed=SEED,
                        dtype=torch.float32, device=dev)
    sim32.setup()
    sim1m = lj_melt_sim(cells=63, t_init=T_INIT, seed=SEED,
                        dtype=torch.float32, device=dev)
    sim1m.setup()
    log(f"[setup] 32k + 1M decks {time.perf_counter() - t0:.1f} s")
    main_cell = kernel_vs_plain(sim32, torch.float32, "32k f32")
    kernel_vs_plain(sim32, torch.float64, "32k f64")
    kernel_vs_plain(sim1m, torch.float32, "1M f32")
    kernel_vs_plain(sim1m, torch.float64, "1M f64")

    # 3. golden step 0 (examples/melt/log.8Apr21.melt.g++.1, f64)
    gold = lj_melt_sim(cells=10, t_init=3.0, seed=SEED, dtype=torch.float64,
                       device=dev)
    gold.setup()
    row = gold.thermo()
    log(f"[golden] step 0: epair {row['epair']:.10f} (log -6.7733681), "
        f"press {row['press']:.10f} (log -3.7033504)")
    if (abs(row["epair"] + 6.7733681) > 2e-7
            or abs(row["press"] + 3.7033504) > 2e-6):
        raise RuntimeError(f"golden step 0 mismatch: {row}")

    # 4. the main path: 32k melt, 1000 steps, counted launches
    pair_kernels.lj_cell_force.launches = 0
    rows = sim32.run(1000, thermo_every=100)
    launches = pair_kernels.lj_cell_force.launches
    log(f"[lj-32k] run(1000): {launches} kernel launches, loop "
        f"{sim32.last_loop_time:.3f} s incl. 11 thermo rows, grid "
        f"{sim32.nl.params.ncells} x cc {sim32.nl.params.cell_cap}")
    if launches <= 0:
        raise RuntimeError("main path never launched the kernel")
    check_run(sim32, rows, "lj-32k")
    step_rate(sim32, 100, "lj-32k")

    # 5. the 1M-atom deck, 200 steps
    pair_kernels.lj_cell_force.launches = 0
    rows = sim1m.run(200, thermo_every=100)
    log(f"[lj-1m] run(200): {pair_kernels.lj_cell_force.launches} kernel "
        f"launches, loop {sim1m.last_loop_time:.3f} s, grid "
        f"{sim1m.nl.params.ncells} x cc {sim1m.nl.params.cell_cap}")
    if pair_kernels.lj_cell_force.launches <= 0:
        raise RuntimeError("1M deck never launched the kernel")
    check_run(sim1m, rows, "lj-1m")
    step_rate(sim1m, 20, "lj-1m")

    print(json.dumps({"kernels": [{
        "name": "lj_cell_force", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "also_replaces": ALSO_REPLACES,
        "launches": launches, **main_cell}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
