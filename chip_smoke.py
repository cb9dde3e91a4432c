#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths (lammps_kokkos_port_tpu_torch) through the
entry points a user calls, the LJ melt (bench/in.lj), the EAM deck
(bench/in.eam, on the synthetic Sutton-Chen stand-in for Cu_u3.eam, which
is not in the repository) and the input-deck front end (script, cli), and
checks them on the card:

  1. device: the card's name and power limit (nvidia-smi); build every
     CUDA kernel from csrc/ with nvcc, one process per source, all at once;
  2. the lj kernel against its plain PyTorch version on the card, at the
     main path's grids (32k-atom deck and 1M-atom deck), f32 and f64, with
     positions jittered by a seeded +-0.05 so forces are not lattice zeros;
     max abs error, the kernel's device time, the plain version's time;
  3. golden step 0: examples/melt in f64 against the reference's log;
  4. the LJ main path: the 32k-atom bench/in.lj melt in f32, setup() +
     run(1000, thermo_every=100), with the kernel's launch count over that
     run, energy drift and the slope-timed step rate;
  5. the 1M-atom deck (cells=63), f32, 200 steps, same checks, and a
     torch.profiler split of one segment (the kernel, re-binning, rest);
  6. the two EAM kernels against their plain versions at the eam-32k grid
     and at the 1M EAM grid (cells 63), f32 and f64, positions jittered by
     a seeded +-0.08 A: the rho sweep with its fp = F'(rho) epilogue (rho
     against the plain rho, fp against embedding_fp of it) and without it,
     and the force sweep; their launch shapes;
  7. the EAM slice on the card against the same slice on the CPU (plain
     versions), cells 6, f64, 10 steps;
  8. the EAM main path: the 32k-atom bench/in.eam deck in f32, setup() +
     run(200, thermo_every=50) (every 1 delay 5 check yes), each EAM
     kernel launched once per force step (one fused rho+fp launch, one
     force launch), nbuilds > 1, energy drift, the slope-timed step rate,
     and a torch.profiler split of one segment, in which embedding_fp must
     not be called; the same deck through the earlier chain (rho sweep,
     embedding_fp in eager PyTorch, force sweep) for device ops, device
     time and host time per step before and after;
  9. the input-deck slice: bench/in.lj with -var x 4 -var y 2 -var z 4
     (1,024,000 atoms) through `script.LammpsScript(list_mode="cell")`,
     f32, the deck's own `run 100`: the cell kernel (K6's port) launched
     once per force step, nbuilds as the cadence gives, finite rows, drift;
     the script's Loop time / Performance lines, per-command setup times,
     the slope-timed step rate, a torch.profiler split, and the cost of a
     re-binning against a host read of the `check yes` decision;
 10. the cell kernel against its plain version at the cell-mode grids of
     the 1M deck (its state after the run) and the 32k deck (positions
     jittered), f32 and f64;
 11. bench/in.lj at 32k through `cli.main([... "-device", "cuda"])` in the
     default mode (auto -> sorted): the lj kernel of phases 2-5 launched;
 12. the examples/melt deck in f64 through LammpsScript on the card against
     the same deck on the CPU (rel 1e-10), and its step-0 golden;
 13. the sorted-kernel ablation entry point, `prof.sorted_ablate.main` at
     the 32k deck (every label of benchmarks/prof/prof_sorted_ablate.py),
     with K7's and the P9 kernels' launches counted over it; K7 against
     its plain version (f32, f64; its launch shape), and on grids of 1, 2
     and 3 cells per dim, at cc 64, and on pairs planted at the cutoff
     across each wrapped face (each row's decision as its twin's), two
     launches bit-equal; lj_cell_force on those pairs (both rows take the
     Newton-half K1's decision, ROADMAP F12); the P9 kernels against
     theirs (f32), pair_only at 14 cc and twice the lanes in one call (the
     time must follow the lanes: ratio >= 1.8), and asm_only's staging
     loads counted in its SASS (cuobjdump);
 14. the Newton-half entry point, `prof.plane_half.main` at cells 20 and 63
     (the labels of prof_v3_32k.py and prof_v3_iso.py), with K8's and
     P10's launches counted over it and their launch shapes; K8 and P10
     against their plain versions and K8 against the full-stencil lj
     kernel (32k and 1M, f32 and f64), with the three kernels' times on
     the same inputs, and K8 against its plain version and the lj kernel
     on the 1M deck's own positions after run(200) (the two kernels agree
     wherever their plain versions do: no component apart on the jittered
     planes, at most 8 on the deck, each within one pair's force at the
     cutoff);
 15. the Newton-half column family, `prof.kernel_iso`, `kernel_writeonce`,
     `halfv2` and `zchunk` `main` at cells 20 (the labels of
     prof_kernel_iso.py, prof_kernel_writeonce.py, prof_halfv2.py and
     prof_zchunk.py), with the launches of every pass of
     prof/column_half_kernels counted over them (P5's five modes, P8, P2
     exact and approximate, P11 fwd and fused); each pass against its
     plain version (32k f32 and f64; P8's forward sums and rc apart and
     its folded forces against lj_cell_force; noassembly all NaN, and its
     SASS read for the pair loop without the staging), every z chunk a
     pass is compiled for against the same twin, `iso_full` against K8
     (one function on one buffer: no component apart), each instance's
     registers, each pass's device time per call (torch.profiler), the P5
     cost split, and P8 against K8 and lj_cell_force on the same inputs;
 16. the last four profiling scripts' paths, `prof.kernel_cc32`,
     `kernel_v3`, `dynslice` and `zwin_proto` `main` at the 32k melt (the
     labels of prof_kernel_cc32.py, prof_kernel_v3.py, prof_dynslice.py
     and prof_zwin_proto.py), with the launches of P3, P4, P6 k1 and k2
     (P7 is k1's instance), P1 and P12 counted over them; each against its
     plain version (32k f32 and f64; P12 f32, per element against the sum
     of the magnitudes of its terms), P3 against lj_cell_force, P6 k1 and
     k2 against each other and K7 and with a pad in the cutoff (K7 against
     its twin there too), k1 (P7's instance) and k2 on phase 13's grids
     and planted pairs, P1 in both modes at G = 512 and G = 128, and each
     kernel's device time per call (P12's bound: every lane-pair's r2 and
     cutoff test, the work the probe defines).

The `[rank]` lines order the kernels for redesign: the decks' kernels by
launches per step times device time above the bound at each deck's size,
the profiling-only kernels apart, one call each.

The entry points' lines (phases 13-16) are slopes of CUDA-graph replays
(prof/timing.slope_ms), device time as the scripts' lax.scan gives it.
Every kernel timed in phases 2-16 is timed by its device time per call
(`device_ms`, torch.profiler), one clock for every entry of the kernel
line: its `ms` and `device_ms` are that time. (A single call's CUDA-event
time would also hold the host's gap before the launch, as long as a kernel
at 32k.) The plain versions, many kernels each, keep CUDA-event medians
(`plain_ms`).

Every kernel in the kernel line carries its bound (bound_ms, bound_by:
the larger of bytes over the HBM rate and operations over the type's
peak, for this run's inputs; PEAK_* and *_PAIR_OPS below; for the P9 and
P4 pair ablations the work they define, every lane of every row, named
in `bound_work`) and library_ms (null: no single PyTorch call computes
these passes).

Every failed check raises (non-zero exit, no result line). The last two
lines are the kernel table and the result, one JSON object each.

Usage, from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

KERNEL_SOURCE = "lammps_kokkos_port_tpu_torch/csrc/lj_cell_force.cu"
# the Pallas kernels it replaces: K1 (32k path), K2 (1M path), K3
REPLACES = "lammps_kokkos_port_tpu/ops/pallas_pair.py:331"
ALSO_REPLACES = ["lammps_kokkos_port_tpu/ops/pallas_pair.py:645",
                 "lammps_kokkos_port_tpu/ops/pallas_pair.py:799"]
EAM_SOURCE = "lammps_kokkos_port_tpu_torch/csrc/eam_cell.cu"
CELL_SOURCE = "lammps_kokkos_port_tpu_torch/csrc/lj_cell_dense.cu"
CELL_REPLACES = "lammps_kokkos_port_tpu/ops/pallas_pair.py:117"  # K6
EAM_REPLACES = {  # K4, K5
    "eam_cell_rho": "lammps_kokkos_port_tpu/ops/pallas_eam.py:200",
    "eam_cell_force": "lammps_kokkos_port_tpu/ops/pallas_eam.py:219",
}
COLUMN_SOURCE = "lammps_kokkos_port_tpu_torch/csrc/lj_column_full.cu"
HALF_SOURCE = "lammps_kokkos_port_tpu_torch/csrc/lj_plane_half.cu"
ABLATE_SOURCE = "lammps_kokkos_port_tpu_torch/csrc/lj_ablate.cu"
PROF_REPLACES = {  # K7, K8, P9, P10
    "lj_column_force": "lammps_kokkos_port_tpu/ops/pallas_pair.py:354",
    "lj_plane_half": "lammps_kokkos_port_tpu/ops/pallas_pair.py:512",
    "lj_ablate": "benchmarks/prof/prof_sorted_ablate.py:171",
    "lj_plane_half_fwd": "benchmarks/prof/prof_v3_iso.py:97",
}
COLUMN_HALF_SOURCE = "lammps_kokkos_port_tpu_torch/csrc/lj_column_half.cu"
COLUMN_HALF_REPLACES = {  # P5, P8, P2, P11, P3: column_half_kernels' passes
    "iso": "benchmarks/prof/prof_kernel_iso.py:99",
    "writeonce": "benchmarks/prof/prof_kernel_writeonce.py:120",
    "halfv2": "benchmarks/prof/prof_halfv2.py:151",
    "zchunk": "benchmarks/prof/prof_zchunk.py:68",
    "cc32": "benchmarks/prof/prof_kernel_cc32.py:182",
}
DYNSLICE_SOURCE = "lammps_kokkos_port_tpu_torch/csrc/dynslice.cu"
ZWIN_SOURCE = "lammps_kokkos_port_tpu_torch/csrc/zwin_proto.cu"
# phase 16's kernels: (name in the line, source, the pallas_call it replaces)
LAST_SITES = {
    "lj_column_half_cc32_half": (COLUMN_HALF_SOURCE,
                                 "benchmarks/prof/prof_kernel_cc32.py:182"),
    "lj_ablate_pair512": (ABLATE_SOURCE,
                          "benchmarks/prof/prof_kernel_cc32.py:239"),
    "lj_column_v3_k1": (COLUMN_SOURCE,
                        "benchmarks/prof/prof_kernel_v3.py:187"),
    "lj_column_v3_k2": (COLUMN_SOURCE,
                        "benchmarks/prof/prof_kernel_v3.py:187"),
    "dynslice": (DYNSLICE_SOURCE, "benchmarks/prof/prof_dynslice.py:52"),
    "zwin_proto": (ZWIN_SOURCE, "benchmarks/prof/prof_zwin_proto.py:108"),
}
P7_SITE = "benchmarks/prof/prof_kernel_v3.py:205"  # k1 again: k1's instance
# asm_only's 14 unrolled staging blocks of 4 channels: global loads in SASS
ASM_ONLY_MIN_LDG = 14 * 4
SEED = 87287
T_INIT = 1.44
# The least time the card could take (bound_ms): the larger of the bytes a
# kernel must move (inputs read once, outputs written once) over the HBM
# rate and its operations over the non-tensor peak of their type; H100 SXM
# data sheet figures (SXM part, dense, at its 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
# Operations per unordered pair within the cutoff, each pair counted once
# so that full-stencil and Newton-half kernels are held to the same work:
# lj: displacement 3, r2 5, cutoff 1, 1/r2 1, r6 2, fpair 4, fij 3, +f_i 3,
# -f_j 3; forward only (P10) drops -f_j; EAM: displacement, r2 and cutoff 9,
# clamp 2, each Clenshaw series 2 + 3 per coefficient (29 for rho, 28 each
# for a and b), rho +2; force fpair 4, fij 3, +f_i 3, -f_j 3. The rho
# sweep's fp epilogue, per valid row: clamp 2, sqrt 1, the argument 2, the
# Fp_s series (80 coefficients), 2 s and the divide 2.
LJ_PAIR_OPS = 25
LJ_FWD_PAIR_OPS = 22
EAM_RHO_PAIR_OPS = 9 + 2 + (2 + 3 * 29) + 2
EAM_FORCE_PAIR_OPS = 9 + 2 + 2 * (2 + 3 * 28) + 4 + 9
EAM_FP_ROW_OPS = 2 + 1 + 2 + (2 + 3 * 80) + 2
# the kernels redesigned for Hopper: on the shared candidate walk
# (csrc/cell_walk.cuh), and the P9 and P4 pair ablations with more rows in
# flight (lj_ablate, whose line's times are pair_only's, and
# lj_ablate_pair512)
REDESIGNED = ("lj_cell_force", "lj_cell_dense", "eam_cell_rho",
              "eam_cell_force", "lj_plane_half", "lj_plane_half_fwd",
              *(f"lj_column_half_{name}" for name in (
                  "iso_full", "iso_batched", "iso_redonly", "iso_noreverse",
                  "iso_noassembly", "writeonce", "halfv2", "halfv2_approx",
                  "zchunk_fwd", "zchunk_fused", "cc32_half")),
              "lj_column_force", "lj_column_v3_k1", "lj_column_v3_k2",
              "lj_ablate", "lj_ablate_pair512", "zwin_proto")
# the bound of the pair ablations: the work they define, every lane of every
# row through the body, not only the pairs a row needs
ABLATION_BOUND = "defined: cap rows x lanes x LJ_FWD_PAIR_OPS"
# P12's bound: the work the probe defines. Its windows are not spatially
# sorted, so no prune can skip a lane-pair: each needs its r2 and cutoff
# test (3 subtractions, 3 products, 2 sums, 1 compare)
ZWIN_TEST_OPS = 9
ZWIN_BOUND = ("defined: every lane-pair x ZWIN_TEST_OPS + the pairs in the "
              "cutoff x LJ_PAIR_OPS")
# pair_only's device time at twice the lanes over its time at 14 * cc = 448
# (the body runs on every lane, so the time must follow the lanes)
LANE_RATIO_MIN = 1.8
# the grids the column walk is held on beyond the melt: 1, 2 and 3 cells
# per dim, and cc 64 with a 40-atom cell (two row passes)
EDGE_GRIDS = (((1, 1, 1), 16), ((2, 2, 4), 32), ((3, 3, 3), 32),
              ((3, 3, 4), 64))
# the library call column: no single PyTorch call computes these passes
LIBRARY_MS = None
EAM_STEPS = 200
# |etotal drift| per atom over EAM_STEPS, eV: a sanity bound, not a physics
# claim (the reference's own in.eam log drifts 6.7e-4 eV/atom per 100 steps)
EAM_DRIFT_BOUND = 0.01

# bench/in.lj of the LAMMPS distribution
IN_LJ = """# 3d Lennard-Jones melt

variable        x index 1
variable        y index 1
variable        z index 1

variable        xx equal 20*$x
variable        yy equal 20*$y
variable        zz equal 20*$z

units           lj
atom_style      atomic

lattice         fcc 0.8442
region          box block 0 ${xx} 0 ${yy} 0 ${zz}
create_box      1 box
create_atoms    1 box
mass            1 1.0

velocity        all create 1.44 87287 loop geom

pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5

neighbor        0.3 bin
neigh_modify    delay 0 every 20 check no

fix             1 all nve

run             100
"""
DECK_1M = {"x": "4", "y": "2", "z": "4"}  # 80 x 40 x 80 fcc cells
DECK_1M_ATOMS = 1_024_000
DECK_STEPS = 100
# examples/melt as tests/test_script.py carries it
MELT_DECK = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 6 0 6 0 6
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 3.0 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    every 20 delay 0 check no
fix             1 all nve
thermo          50
run             50
"""


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


def device_ms(fns: dict, rounds: int = 3, inner: int = 20) -> dict:
    """Device time per call of each of `fns`, in ms: torch.profiler's
    summed duration of the device ops of `inner` calls, over `inner`; the
    fns take turns, `rounds` times, and the median is kept
    (prof/redesign.device_times: a warm-up step with the profiler on, and a
    trace that lost device records taken again and logged as
    `[device_ms]`). Unlike an event pair around the calls it holds no gap
    in which the device waits for the host, which at the 32k grid is as
    long as a kernel."""
    from lammps_kokkos_port_tpu_torch.prof.redesign import device_times

    return device_times(fns, rounds, inner)


def one_device_ms(fn) -> float:
    """device_ms of one function."""
    return device_ms({"fn": fn})["fn"]


def bound_of(pairs: int, pair_ops: int, nbytes: int, dtype,
             row_ops: int = 0) -> dict:
    """bound_ms / bound_by of a pass doing `pair_ops` operations on each of
    `pairs` unordered pairs and `row_ops` more, moving `nbytes` (PEAK_*
    above)."""
    t_ops = ((pairs * pair_ops + row_ops)
             / PEAK_OPS_PER_S[str(dtype).split(".")[-1]])
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return {"pairs": pairs, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": LIBRARY_MS}


def grid_pairs(ncells, gx, gy, gz, prd, cutsq, own_cell=False) -> int:
    """Unordered pairs within the cutoff on a cell-major grid: the plain
    twins' 27-cell walk (with `own_cell`, the own cell only) without its
    self lane, counted and halved (padding rows sit far from every row)."""
    import torch

    from lammps_kokkos_port_tpu_torch.ops import pair_kernels

    kw = {"offsets": [(0, 0, 0)]} if own_cell else {}
    n = 0
    with torch.no_grad():
        for _, r2, pair_ok, _ in pair_kernels.stencil(ncells, gx, gy, gz, prd,
                                                      **kw):
            ok = r2 < cutsq
            if pair_ok is not None:
                ok &= pair_ok
            n += int(ok.sum())
    return n // 2


def dense_pairs(buckets, stencil, x, prd, cutsq, chunk: int = 4096) -> int:
    """Unordered pairs within the cutoff over list mode "cell"'s buckets,
    with the minimum image, as the cell kernel masks them."""
    import torch

    cap = x.shape[0]
    ntot = buckets.shape[0] - 1
    valid_b = buckets < cap
    xb = x[torch.clamp(buckets, max=cap - 1).long()]
    n = 0
    for c0 in range(0, ntot, chunk):
        cids = slice(c0, min(c0 + chunk, ntot))
        n27 = stencil[cids].long()
        nch = n27.shape[0]
        live = (n27 < ntot)[:, :, None].expand(-1, -1, buckets.shape[1])
        cand_valid = valid_b[n27] & live
        d = xb[cids][:, :, None, :] - xb[n27].reshape(nch, 1, -1, 3)
        d = d - prd * torch.round(d * (1.0 / prd))
        r2 = (d * d).sum(-1)
        ok = ((r2 < cutsq) & valid_b[cids][:, :, None]
              & cand_valid.reshape(nch, 1, -1)
              & (buckets[cids][:, :, None]
                 != buckets[n27].reshape(nch, 1, -1)))
        n += int(ok.sum())
    return n // 2


def check_close(label: str, got, ref, rtol: float) -> float:
    """Each component of `got` within rtol*max|ref| + rtol*|ref| of `ref`
    (tensors or sequences of tensors); raises otherwise. Returns the max
    abs error."""
    import torch

    got = torch.cat([a.reshape(-1) for a in got]) if isinstance(
        got, (tuple, list)) else got
    ref = torch.cat([a.reshape(-1) for a in ref]) if isinstance(
        ref, (tuple, list)) else ref
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: kernel output is not finite")
    vmax = ref.abs().max().item()
    err = (got - ref).abs()
    bad = int((err > rtol * vmax + rtol * ref.abs()).sum())
    if bad:
        raise RuntimeError(f"{label}: {bad} values out of tolerance (rtol "
                           f"{rtol:g}, max abs err {err.max().item():.3e}, "
                           f"max|ref| {vmax:.6g})")
    return err.max().item()


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
    dev_ms = one_device_ms(lambda: lj_cell_force(*args))
    plain_ms = cuda_ms(lambda: lj_cell_force_reference(*args), reps=5,
                       warmup=1)
    rows = p.total_cells * p.cell_cap
    bound = bound_of(grid_pairs(p.ncells, g[0], g[1], g[2], prd, key[-1]),
                     LJ_PAIR_OPS, rows * 6 * g.element_size(), dtype)
    log(f"[kernel] {label}: grid {p.ncells} x cc {p.cell_cap} "
        f"({rows} rows), max|f| {fmax:.6g}, "
        f"max abs err {max_abs:.3e}, max rel err {max_rel:.3e} "
        f"(rtol {rtol:g}, atol {rtol:g}*max|f|), device {dev_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, "
        f"{bound['pairs']} pairs in the cutoff, bound "
        f"{bound['bound_ms']:.4g} ms ({bound['bound_by']})")
    if bad:
        raise RuntimeError(f"{label}: {bad} force components out of "
                           "tolerance")
    return {"max_abs_err": max_abs, "ms": dev_ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **bound}


def log_walk_launch(name: str, ncells, cc: int, shape) -> None:
    """The launch a cell_walk.cuh kernel makes on the grid, as its library
    computes it (`shape(dtype)`: blocks, threads per block, dynamic shared
    memory); ptxas does not report dynamic shared memory."""
    import torch

    f32, f64 = shape(torch.float32), shape(torch.float64)
    log(f"[build] {name} launch on grid {tuple(ncells)} x cc {cc}: "
        f"{f32['blocks']} blocks of {f32['threads'][0]} x "
        f"{f32['threads'][1]} threads, dynamic shared memory per block "
        f"{f32['smem_bytes']} B f32 / {f64['smem_bytes']} B f64")


def kernel_on_deck_state(sim, label: str) -> None:
    """Device time per call of lj_cell_force on the deck's own positions
    (the state after its runs, no jitter), beside the kernel line's time
    on the jittered lattice: whether the kernel's time inside the step
    differs from the kernel line's by its inputs."""
    from lammps_kokkos_port_tpu_torch.ops.pair_kernels import lj_cell_force
    from lammps_kokkos_port_tpu_torch.ops.sortedforce import PAD_POS

    st, p = sim.state, sim.nl.params
    g = st.x.t().contiguous().reshape(3, p.total_cells, p.cell_cap)
    args = (sim.pair_style.kernel_key(), p.ncells, g[0], g[1], g[2],
            st.box.prd)
    ms = one_device_ms(lambda: lj_cell_force(*args))
    pairs = grid_pairs(p.ncells, g[0], g[1], g[2], st.box.prd, args[0][-1])
    log(f"[{label} kernel on the deck's state] device {ms:.4f} ms per "
        f"call, {pairs} pairs in the cutoff, "
        f"{int((g[0] < PAD_POS / 2).sum())} real rows")


def check_run(sim, rows, label: str, bound: float = 0.02) -> None:
    """Finite thermo (run() already raises otherwise), clear overflow, and
    |etotal drift| per atom under `bound`."""
    for r in rows:
        if not all(math.isfinite(v) for v in r.values()
                   if isinstance(v, float)):
            raise RuntimeError(f"{label}: non-finite thermo {r}")
    if bool(sim.nl.overflow):
        raise RuntimeError(f"{label}: capacity overflow flag set")
    drift = rows[-1]["etotal"] - rows[0]["etotal"]
    if not sim.units.norm_default:  # metal units: thermo is not per atom
        drift /= sim.state.nlocal
    log(f"[{label}] etotal step {rows[0]['step']} {rows[0]['etotal']:.7f} "
        f"-> step {rows[-1]['step']} {rows[-1]['etotal']:.7f} "
        f"(drift {drift:.3e} per atom), temp {rows[-1]['temp']:.6f}, "
        f"press {rows[-1]['press']:.6f}")
    # a sanity bound, not a physics claim
    if abs(drift) >= bound:
        raise RuntimeError(f"{label}: |etotal drift| {abs(drift)} per atom "
                           f">= {bound}")


def step_rate(sim, k1: int, label: str, reps: int = 5) -> float:
    """Steady-state ms/step from two segment lengths (k1, 3*k1), so the
    fixed per-segment cost cancels (as bench.py does). The two lengths run
    in turns, `reps` times each, from the same state; the slope is taken
    between their median times (host-clock times of a host-bound loop
    spread more than device times). Returns seconds per step."""
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
    return per_step


def eam_kernels_vs_plain(sim, dtype, label: str, plain_reps: int = 5) -> dict:
    """Phase 6 on one grid and dtype: the fused rho sweep (rho against the
    plain rho, fp = F'(rho) against embedding_fp of the plain rho), the
    rho sweep without its epilogue, and the force sweep fed the fp of the
    plain rho, each against its plain version on the same inputs. Returns
    {kernel name: numbers} for the kernel line (eam_cell_rho: the fused
    launch, the one the main path makes)."""
    import torch

    from lammps_kokkos_port_tpu_torch.ops import eam_kernels as ek
    from lammps_kokkos_port_tpu_torch.ops.eamdense import embedding_fp

    st, p = sim.state, sim.nl.params
    gen = torch.Generator(device=st.device).manual_seed(SEED)
    jitter = (torch.rand(st.x.shape, generator=gen, device=st.device,
                         dtype=torch.float64) - 0.5) * 0.16
    x = torch.where(st.valid_mask[:, None], st.x.double() + jitter,
                    st.x.double()).to(dtype)
    ncell, cc = p.total_cells, p.cell_cap
    g = x.t().contiguous().reshape(3, ncell, cc)
    prd = st.box.prd.to(dtype)
    tabs = sim.pair_style.poly_tables
    cutsq = float(sim.pair_style.cutmax) ** 2
    rtab, ftab = ek.rho_tab(tabs, cutsq), ek.force_tab(tabs, cutsq)
    rho_args = (rtab, p.ncells, g[0], g[1], g[2], prd)
    fused_args = (rtab, ek.fp_tab(tabs), p.ncells, g[0], g[1], g[2],
                  st.valid_mask, prd)
    rho_ref = ek.eam_cell_rho_reference(*rho_args)
    fp_ref = embedding_fp(tabs, rho_ref.reshape(-1), st.valid_mask)
    gfp = fp_ref.to(dtype).reshape(ncell, cc)
    f_args = (ftab, p.ncells, g[0], g[1], g[2], gfp, prd)
    # tolerances: kernel and plain version make the same cutoff decisions
    # (r2 is rounded alike); the series and the sums round and order
    # differently. atol scaled by max|value| covers cancelling rows.
    rtol = 1e-4 if dtype == torch.float32 else 1e-10
    rho, fp = ek.eam_cell_rho_fp(*fused_args)
    errs = {"eam_cell_rho": check_close(f"{label} eam_cell_rho_fp rho", rho,
                                        rho_ref, rtol)}
    fp_err = check_close(f"{label} eam_cell_rho_fp fp", fp.reshape(-1),
                         fp_ref, rtol)
    check_close(f"{label} eam_cell_rho (no epilogue)",
                ek.eam_cell_rho(*rho_args), rho_ref, rtol)
    errs["eam_cell_force"] = check_close(
        f"{label} eam_cell_force", ek.eam_cell_force(*f_args),
        ek.eam_cell_force_reference(*f_args), rtol)
    dev = device_ms({"eam_cell_rho": lambda: ek.eam_cell_rho_fp(*fused_args),
                     "eam_cell_force": lambda: ek.eam_cell_force(*f_args)})
    plain = {"eam_cell_rho": cuda_ms(
                 lambda: ek.eam_cell_rho_fp_reference(*fused_args),
                 reps=plain_reps, warmup=1),
             "eam_cell_force": cuda_ms(
                 lambda: ek.eam_cell_force_reference(*f_args),
                 reps=plain_reps, warmup=1)}
    rows = ncell * cc
    pairs = grid_pairs(p.ncells, g[0], g[1], g[2], prd, cutsq)
    item = g.element_size()
    bounds = {"eam_cell_rho": bound_of(
                  pairs, EAM_RHO_PAIR_OPS, rows * (5 * item + 1), dtype,
                  row_ops=int(st.valid_mask.sum()) * EAM_FP_ROW_OPS),
              "eam_cell_force": bound_of(pairs, EAM_FORCE_PAIR_OPS,
                                         rows * 7 * item, dtype)}
    out = {}
    for name in ("eam_cell_rho", "eam_cell_force"):
        b = bounds[name]
        extra = (f" (fp: max abs err {fp_err:.3e}, max|fp| "
                 f"{fp_ref.abs().max().item():.6g})"
                 if name == "eam_cell_rho" else "")
        log(f"[kernel] {label} {name}: grid {p.ncells} x cc {cc} "
            f"({rows} rows), max abs err {errs[name]:.3e}{extra} (rtol "
            f"{rtol:g}, atol {rtol:g}*max), device {dev[name]:.4f} ms, plain "
            f"{plain[name]:.4f} ms, {pairs} pairs in the cutoff, bound "
            f"{b['bound_ms']:.4g} ms ({b['bound_by']})")
        out[name] = {"max_abs_err": errs[name], "ms": dev[name],
                     "device_ms": dev[name], "plain_ms": plain[name], **b}
    out["eam_cell_rho"]["fp_max_abs_err"] = fp_err
    return out


def unfused_force_sorted(style, tabs, state, cl):
    """The force-only EAM pass as the earlier port chained it: the rho
    sweep without its epilogue, fp = F'(rho) in eager PyTorch
    (`embedding_fp`, about 165 launches), the force sweep. For the
    profile's before-and-after only; the port does not call it."""
    from lammps_kokkos_port_tpu_torch.ops import eam_kernels as ek
    from lammps_kokkos_port_tpu_torch.ops import eamdense
    from lammps_kokkos_port_tpu_torch.ops.sortedforce import planar

    p = cl.params
    g = planar(state.x).reshape(3, p.total_cells, p.cell_cap)
    prd = state.box.prd.to(state.dtype)
    cutsq = float(style.cutmax) ** 2
    rho = ek.eam_cell_rho(ek.rho_tab(tabs, cutsq), p.ncells, g[0], g[1],
                          g[2], prd)
    gfp = eamdense.embedding_fp(tabs, rho.reshape(-1),
                                state.valid_mask).reshape(rho.shape)
    f = ek.eam_cell_force(ek.force_tab(tabs, cutsq), p.ncells, g[0], g[1],
                          g[2], gfp, prd)
    return f.reshape(3, state.capacity).t().contiguous()


@contextlib.contextmanager
def replaced(targets):
    """Set module attributes for the duration, without touching the
    library: [(module, attribute, value), ...]."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for mod, name, value in targets:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def eam_card_vs_cpu(pot: str) -> None:
    """Phase 7: the EAM slice, cells 6, f64, 10 steps, on the card and on
    the CPU (plain versions): thermo rel 1e-10."""
    import torch

    from lammps_kokkos_port_tpu_torch.presets import eam_bulk_cu_sim

    rows = {}
    for dev in ("cuda", "cpu"):
        sim = eam_bulk_cu_sim(cells=6, dtype=torch.float64, device=dev,
                              potential_path=pot, list_mode="sorted")
        sim.setup()
        rows[dev] = sim.run(10, thermo_every=10)
    for a, b in zip(rows["cuda"], rows["cpu"]):
        for k in ("temp", "pe", "etotal", "press"):
            if not math.isclose(a[k], b[k], rel_tol=1e-10):
                raise RuntimeError(f"eam card vs cpu, step {a['step']} {k}:"
                                   f" {a[k]!r} vs {b[k]!r}")
    last = rows["cuda"][-1]
    log(f"[eam-small] cells 6 f64, 10 steps: card and CPU agree at rel "
        f"1e-10 (step 10 etotal {last['etotal']:.10f}, press "
        f"{last['press']:.6f})")


@contextlib.contextmanager
def annotated(targets):
    """Wrap module functions in torch.profiler ranges for one profile,
    without touching the library: [(module, attribute, label), ...]."""
    from torch.profiler import record_function

    saved = []
    for mod, name, label in targets:
        fn = getattr(mod, name)

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            with record_function(_label):
                return _fn(*args, **kwargs)

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def segment_trace(run, labels) -> tuple:
    """One torch.profiler trace of run(), taken after a warm-up call of
    run() with the profiler on (prof/redesign.trace's schedule), the
    functions of `labels` ({range: [(module, function), ...]}) wrapped in
    their ranges: (its events, its device ops, the traced call's wall s).
    The device ops leave out the ranges' own device-side spans (first to
    last kernel, gaps included), which are not device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    kept, wall = [], []

    def keep(prof):
        kept.append(prof.events())

    targets = [(m, n, lab) for lab, fns in labels.items() for m, n in fns]
    with annotated(targets):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=keep) as prof:
            for _ in range(2):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
                prof.step()
    events = kept[0]
    ops = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in labels and not e.name.startswith("ProfilerStep")]
    return events, ops, wall[-1]


def profile_segment(sim, nsteps: int, ms_per_step: float, label: str,
                    kernels, labels) -> dict:
    """torch.profiler over one segment of `nsteps` after a warm-up: device
    time per step of each kernel in `kernels` (by kernel name), of each
    profiler range in `labels` ({range: [(module, function), ...]}, the
    named functions of the step wrapped in that range) and the rest; the
    device idle share against the unprofiled ms/step. The ranges hold only
    PyTorch ops: the trace does not attribute the kernels launched through
    ctypes to an enclosing range. Every trace runs the same segment (the
    runner returns a new state and leaves sim's as it is), so its device
    ops are the same in each: a trace is kept when a second one holds as
    many device ops and none holds more, or when three agree (one trace
    has held more than all others, seen once on an H100: it is
    outvoted); one that lost records is taken again
    (prof/redesign.TRACE_ATTEMPTS times at most), and the count of traces
    taken again is logged. Returns the device ms per step of each part,
    the device busy ms per step and the device ops per step."""
    from torch.autograd import DeviceType

    from lammps_kokkos_port_tpu_torch.prof.redesign import TRACE_ATTEMPTS

    runner = sim._get_segment_runner()
    runner(sim.state, sim.nl, nsteps)  # warm-up
    traces = []
    while True:
        traces.append(segment_trace(
            lambda: runner(sim.state, sim.nl, nsteps), labels))
        counts = [len(ops) for _, ops, _ in traces]
        most = max(counts)
        if counts.count(most) >= 2 and most > 0:
            break
        agreed = [n for n in counts if counts.count(n) >= 3 and n > 0]
        if agreed:
            most = agreed[0]
            break
        if len(traces) >= TRACE_ATTEMPTS + 2:
            raise RuntimeError(f"{label} profile: no two traces agree on the"
                               f" device ops of the segment: {counts}")
    events, ops, wall = traces[counts.index(most)]
    total = sum(e.time_range.elapsed_us() for e in ops)
    if total <= 0:
        raise RuntimeError("profile: the trace shows no device time")
    split = {name: sum(e.time_range.elapsed_us() for e in ops
                       if f"{name}_kernel" in e.name)
             for name in kernels}
    for lab in labels:
        split[lab] = sum(e.device_time_total for e in events
                         if e.device_type == DeviceType.CPU
                         and e.name == lab)
    if not all(split.values()):
        raise RuntimeError(f"profile: a part shows no device time: {split}")
    split["rest"] = total - sum(split.values())
    per = {k: v / nsteps / 1e3 for k, v in split.items()}  # ms per step
    busy = total / nsteps / 1e3
    log(f"[{label} profile] {nsteps} steps, device time per step "
        + ", ".join(f"{k} {v:.4f} ms ({100 * v / busy:.1f}%)"
                    for k, v in per.items())
        + f"; device busy {busy:.4f} ms/step over {len(ops) / nsteps:.1f} "
        f"device ops/step; profiled wall {wall / nsteps * 1e3:.4f} ms/step;"
        f" idle share vs unprofiled {ms_per_step * 1e3:.4f} ms/step: "
        f"{100 * (1 - busy / (ms_per_step * 1e3)):.1f}%; traces taken "
        f"again {len(traces) - 2} (device ops per trace {counts})")
    return {"per_step": per, "busy_ms": busy,
            "ops_per_step": len(ops) / nsteps,
            "traces_taken_again": len(traces) - 2}


@contextlib.contextmanager
def counted_segment_steps(steps: list):
    """Record the length of every segment the runner's generic step
    segment is asked to run (each step is one force pass), without
    touching the library."""
    from lammps_kokkos_port_tpu_torch import runner as runner_mod

    make = runner_mod.make_step_segment

    def counting_make(*args, **kwargs):
        seg = make(*args, **kwargs)

        def run(state, nl, nsteps):
            steps.append(nsteps)
            return seg(state, nl, nsteps)

        return run

    runner_mod.make_step_segment = counting_make
    try:
        yield
    finally:
        runner_mod.make_step_segment = make


def run_deck(script, path: str) -> tuple[list, dict]:
    """script.file(path), collecting the thermo rows the script prints and
    the wall time of each command (the script's `one`)."""
    rows, times = [], {}
    emit, one = script._emit_thermo_row, script.one

    def emit_row(*args):
        rows.append(emit(*args))
        return rows[-1]

    def timed_one(line):
        t0 = time.perf_counter()
        one(line)
        words = line.split("#")[0].split()
        if words:
            times[words[0]] = (times.get(words[0], 0.0)
                               + time.perf_counter() - t0)

    script._emit_thermo_row, script.one = emit_row, timed_one
    script.file(path)
    return rows, times


def cell_kernel_vs_plain(sim, dtype, label: str, jitter: float) -> dict:
    """Phase 10 on one grid and dtype: the cell kernel against its plain
    version on the sim's buckets, positions (jittered by a seeded
    +-jitter/2 where jitter > 0) in `dtype`."""
    import torch

    from lammps_kokkos_port_tpu_torch.ops.cell_kernels import (
        lj_cell_dense, lj_cell_dense_reference)

    st, cl = sim.state, sim.nl
    x = st.x.double()
    if jitter > 0:
        gen = torch.Generator(device=st.device).manual_seed(SEED)
        x = torch.where(st.valid_mask[:, None], x + (torch.rand(
            x.shape, generator=gen, device=st.device,
            dtype=torch.float64) - 0.5) * jitter, x)
    x = x.to(dtype)
    prd = st.box.prd.to(dtype)
    key = sim.pair_style.kernel_key()
    args = (key, cl.buckets, cl.stencil, x, prd)
    f = lj_cell_dense(*args)
    ref = lj_cell_dense_reference(*args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(f).all()):
        raise RuntimeError(f"{label}: kernel forces are not finite")
    # tolerances as for the lj kernel: the same cutoff decisions (minimum
    # image and r2 rounded alike), the sums in another order
    rtol = 1e-4 if dtype == torch.float32 else 1e-10
    fmax = ref.abs().max().item()
    err = (f - ref).abs()
    bad = int((err > rtol * fmax + rtol * ref.abs()).sum())
    max_abs = err.max().item()
    dev_ms = one_device_ms(lambda: lj_cell_dense(*args))
    plain_ms = cuda_ms(lambda: lj_cell_dense_reference(*args), reps=3,
                       warmup=1)
    p = cl.params
    nbytes = ((cl.buckets.numel() + cl.stencil.numel()) * 4
              + 2 * x.numel() * x.element_size())
    bound = bound_of(dense_pairs(cl.buckets, cl.stencil, x, prd, key[-1]),
                     LJ_PAIR_OPS, nbytes, dtype)
    log(f"[cell kernel] {label}: grid {p.ncells} x cc {p.cell_cap} "
        f"({p.total_cells * p.cell_cap} lanes, {st.nlocal} atoms), max|f| "
        f"{fmax:.6g}, max abs err {max_abs:.3e} (rtol {rtol:g}, atol "
        f"{rtol:g}*max|f|), device {dev_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, {bound['pairs']} pairs in the cutoff, "
        f"bound {bound['bound_ms']:.4g} ms ({bound['bound_by']})")
    if bad or fmax <= 0:
        raise RuntimeError(f"{label}: {bad} force components out of "
                           "tolerance (or all zero)")
    return {"max_abs_err": max_abs, "ms": dev_ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **bound}


def host_ms(fn, reps: int = 10) -> float:
    """Median host time of fn() in ms, each call ended by a synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def deck_1m_cell(tmp: str) -> tuple:
    """Phase 9: the 1M in.lj deck through LammpsScript(list_mode="cell").
    Returns (the script, the cell kernel's launches over the deck)."""
    import dataclasses

    import torch

    from lammps_kokkos_port_tpu_torch.ops import cell_kernels, cellforce
    from lammps_kokkos_port_tpu_torch.script import LammpsScript

    path = os.path.join(tmp, "in.lj")
    Path(path).write_text(IN_LJ)
    script = LammpsScript(dtype=torch.float32, device="cuda",
                          list_mode="cell", var_overrides=DECK_1M)
    steps = []
    t0 = time.perf_counter()
    cell_kernels.lj_cell_dense.launches = 0
    with counted_segment_steps(steps):
        rows, times = run_deck(script, path)
    launches = cell_kernels.lj_cell_dense.launches
    wall = time.perf_counter() - t0
    sim = script.sim
    n, p = sim.state.nlocal, sim.nl.params
    loop = sim.last_loop_time
    log(f"[lj-1m-cell] deck wall {wall:.3f} s, loop {loop:.3f} s, setup "
        f"(wall - loop) {wall - loop:.3f} s; per command "
        + ", ".join(f"{k} {v:.3f} s" for k, v in
                    sorted(times.items(), key=lambda kv: -kv[1])[:6]))
    # one launch per force pass: the setup pass and every step of every
    # segment run (an overflow retry re-runs its segment from the start)
    expect = 1 + sum(steps)
    log(f"[lj-1m-cell] {n} atoms, grid {p.ncells} x cc {p.cell_cap}, "
        f"{launches} cell kernel launches (expected {expect}: setup + "
        f"segments {steps}, {len(steps) - 1} overflow retries), nbuilds "
        f"{sim.nl.nbuilds}")
    if n != DECK_1M_ATOMS:
        raise RuntimeError(f"lj-1m-cell: {n} atoms, not {DECK_1M_ATOMS}")
    if launches != expect or sum(steps) < DECK_STEPS:
        raise RuntimeError(f"lj-1m-cell: {launches} launches for {expect} "
                           "force passes")
    if sim.nl.nbuilds != 1 + DECK_STEPS // 20:
        raise RuntimeError(f"lj-1m-cell: nbuilds {sim.nl.nbuilds}, not "
                           f"{1 + DECK_STEPS // 20}")
    if [r["step"] for r in rows] != [0, DECK_STEPS]:
        raise RuntimeError(f"lj-1m-cell: rows at {[r['step'] for r in rows]}")
    check_run(sim, rows, "lj-1m-cell")

    # the `check yes` decision: a host read of the displacement flag on a
    # cadence step against the re-binning a device-side selection would
    # run on every step
    cl_check = dataclasses.replace(
        sim.nl, ago=19, params=dataclasses.replace(p, check=True))
    read_ms = host_ms(lambda: cellforce.needs_rebuild(sim.state, cl_check))
    rebin_ms = host_ms(lambda: cellforce.rebuild_merge(sim.state, sim.nl))
    log(f"[lj-1m-cell] check-yes decision: host read of the flag "
        f"{read_ms:.4f} ms, re-binning {rebin_ms:.4f} ms (median of 10, "
        "host clock, synchronised)")
    return script, launches


def jittered_planes(sim, dtype):
    """prof.grid.sorted_planes of `sim` in `dtype`, the real rows' positions
    jittered by the seeded +-0.05 of phase 2."""
    import torch

    from lammps_kokkos_port_tpu_torch.prof.grid import sorted_planes

    st = sim.state
    gen = torch.Generator(device=st.device).manual_seed(SEED)
    jitter = (torch.rand(st.x.shape, generator=gen, device=st.device,
                         dtype=torch.float64) - 0.5) * 0.1
    x = torch.where(st.valid_mask[:, None], st.x.double() + jitter,
                    st.x.double())
    return sorted_planes(sim, x, dtype=dtype)


def timed_check(label, kernel, plain, args, rtol, bound) -> dict:
    """A kernel against its plain version on `args`: the max abs error
    (check_close), the kernel's device time, the plain version's median
    CUDA-event time, and `bound`."""
    err = check_close(label, kernel(*args), plain(*args), rtol)
    dev_ms = one_device_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args), reps=3, warmup=1)
    log(f"[kernel] {label}: max abs err {err:.3e} (rtol {rtol:g}, atol "
        f"{rtol:g}*max), device {dev_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{bound['pairs']} pairs, bound "
        f"{bound['bound_ms']:.4g} ms ({bound['bound_by']})")
    return {"max_abs_err": err, "ms": dev_ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **bound}


SASS_OPS = {"LDG": r"\bLDG", "LDS": r"\bLDS", "MUFU.RCP": r"\bMUFU\.RCP"}


def sass_counts(source, marker: str, ops=None) -> dict:
    """{function name: {op: count}} of the functions of `source`'s built
    library whose mangled name holds `marker`, read with cuobjdump; `ops`
    {op: regex} (default SASS_OPS: LDG counts every instruction whose name
    starts so, LDGSTS and LDGDEPBAR too)."""
    import re
    import shutil

    from lammps_kokkos_port_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(cuda_build.lib_path(source))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        if marker in name:
            out[name] = {op: len(re.findall(rx, part))
                         for op, rx in (ops or SASS_OPS).items()}
    return out


def asm_only_loads() -> dict:
    """Global loads (LDG) in the SASS of each asm_only instance, read with
    cuobjdump from the built library: all 14 blocks' staging must be
    there, or V2 measures nothing."""
    from lammps_kokkos_port_tpu_torch.prof import ablate_kernels

    loads = {"f64" if "asm_only_kernelId" in name else "f32": c["LDG"]
             for name, c in sass_counts(ablate_kernels.SOURCE,
                                        "asm_only").items()}
    log(f"[build] asm_only SASS global loads (cuobjdump -sass): {loads}, "
        f"at least {ASM_ONLY_MIN_LDG} = 14 blocks x 4 channels")
    if len(loads) != 2 or min(loads.values()) < ASM_ONLY_MIN_LDG:
        raise RuntimeError(f"asm_only does not stage every block: {loads}")
    return loads


def column_edge_checks(dev, name: str, fn, plain) -> dict:
    """K7, P6 k1 or k2 (`fn`, its twin `plain`) on the inputs its walk finds
    hard, f32 (rtol 1e-4) and f64 (1e-10): lattice grids of EDGE_GRIDS
    (prof.planted.lattice_grid: jittered atoms at random lanes among pads,
    float ids); a pair planted across each periodic face at r2 = cutsq in
    K1's frame and one ulp either side (prof.planted.wrapped_pairs), each
    row taking its twin's decision, which is the candidate frame's, as JAX
    K7 shifts the candidate; and two launches on the melt-sized lattice
    bit-equal. Returns {"max_abs_err", "checks"}."""
    import torch

    from lammps_kokkos_port_tpu_torch.prof import planted

    key = ("lj", 48.0, 24.0, 6.25)
    errs, checks = [], 0
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        for ncells, cc in EDGE_GRIDS:
            ncell = ncells[0] * ncells[1] * ncells[2]
            counts = [(c * 5) % (min(cc, 32) // 2) + 2 for c in range(ncell)]
            if cc > 32:
                counts[ncell // 2] = 40
            g, prd, valid = planted.lattice_grid(ncells, cc, counts, 5, dtype,
                                                 dev)
            ids = torch.where(valid, torch.arange(valid.numel(), device=dev)
                              .reshape(valid.shape), -1).to(dtype)
            shape = (ncells[0] * ncells[1], ncells[2], cc)
            args = (key, ncells, *(a.reshape(shape) for a in g),
                    ids.reshape(shape), prd)
            got = fn(*args)
            errs.append(check_close(f"{name} grid {ncells} x cc {cc} {dtype}",
                                    got, plain(*args), rtol))
            if ncells == (3, 3, 4):
                again = fn(*args)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise RuntimeError(f"{name}: two launches differ")
            checks += 1
        for case in planted.CASES:
            prd = torch.full((3,), 10.2, dtype=dtype)
            g, gi, rows, dec = planted.wrapped_pairs((3, 3, 3), 32, prd,
                                                     key[3], dtype, case,
                                                     device=dev)
            args = (key, (3, 3, 3), *(a.reshape(9, 3, 32) for a in g),
                    gi.reshape(9, 3, 32), prd.to(dev))
            got, ref = fn(*args), plain(*args)
            errs.append(check_close(f"{name} wrapped pair {case} {dtype}",
                                    got, ref, rtol))
            want = {axis: d["candidate"] for axis, d in dec.items()}
            taken = [planted.taken(torch.stack([a.reshape(-1) for a in f]),
                                   rows) for f in (got, ref)]
            if taken != [want, want]:
                raise RuntimeError(f"{name} wrapped pair {case} {dtype}: "
                                   f"decisions {taken}, want {want}")
            checks += 1
    log(f"[edge] {name}: {checks} checks against its twin (grids "
        f"{[g for g, _ in EDGE_GRIDS]}, cc up to 64, pairs at the cutoff "
        f"across each wrapped face, two launches bit-equal), max abs err "
        f"{max(errs):.3e}")
    return {"max_abs_err": max(errs), "checks": checks}


def cell_force_frame_check(dev) -> float:
    """lj_cell_force on a pair planted across each periodic face at r2 =
    cutsq in K1's frame and one ulp either side, f32 and f64: both rows of
    each pair take K1's one decision in the kernel and its twin (ROADMAP
    F12). Returns the max abs error."""
    import torch

    from lammps_kokkos_port_tpu_torch.ops import pair_kernels
    from lammps_kokkos_port_tpu_torch.prof import planted

    key = ("lj", 48.0, 24.0, 6.25)
    errs = []
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        for case in planted.CASES:
            prd = torch.full((3,), 10.2, dtype=dtype)
            g, _, rows, dec = planted.wrapped_pairs((3, 3, 3), 32, prd,
                                                    key[3], dtype, case,
                                                    device=dev)
            args = (key, (3, 3, 3), *g, prd.to(dev))
            got = pair_kernels.lj_cell_force(*args)
            ref = pair_kernels.lj_cell_force_reference(*args)
            errs.append(check_close(f"lj_cell_force wrapped pair {case} "
                                    f"{dtype}", got, ref, rtol))
            want = {axis: d["half"] for axis, d in dec.items()}
            taken = [planted.taken(f, rows) for f in (got, ref)]
            if taken != [want, want]:
                raise RuntimeError(f"lj_cell_force wrapped pair {case} "
                                   f"{dtype}: decisions {taken}, want {want}")
    log(f"[edge] lj_cell_force: pairs at the cutoff across each wrapped face"
        f" (f32, f64, 3 cases): both rows take K1's decision, max abs err "
        f"{max(errs):.3e}")
    return max(errs)


def phase_sorted_ablate(dev) -> dict:
    """13. prof.sorted_ablate.main at the 32k deck, with the launches of K7
    and the P9 kernels counted over it; then K7 against its twin (f32 and
    f64, jittered) and the P9 kernels against theirs (f32; asm_only on the
    script's inputs, exactly; the pair variants on inputs where their math
    is live, since on the melt no row passes 0 <= id < 3 within the cutoff
    of the constant candidate). Returns the kernel line's entries."""
    import torch

    from lammps_kokkos_port_tpu_torch.ops import column_kernels as ck
    from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
    from lammps_kokkos_port_tpu_torch.prof import ablate_kernels as ak
    from lammps_kokkos_port_tpu_torch.prof import sorted_ablate
    from lammps_kokkos_port_tpu_torch.prof.grid import sorted_planes

    sim = lj_melt_sim(cells=20, t_init=T_INIT, seed=SEED,
                      dtype=torch.float32, device=dev)
    sim.setup()
    counted = {"lj_column_force": ck.lj_column_force,
               "asm_only": ak.asm_only, "pair_only": ak.pair_only,
               "pair_only_approx": ak.pair_only_approx}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = sorted_ablate.main(cells=20, device=dev, sim=sim)
    launches = {k: fn.launches for k, fn in counted.items()}
    log(f"[prof-ablate] sorted_ablate.main(cells=20): "
        f"{time.perf_counter() - t0:.1f} s, launches {launches}, lines (ms;"
        f" step eager, the rest graph replays) {res}")
    if min(launches.values()) <= 0 or not all(
            math.isfinite(v) for v in res.values()):
        raise RuntimeError(f"sorted_ablate: launches {launches}, {res}")
    loads = asm_only_loads()

    out = {}
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        sp = jittered_planes(sim, dtype)
        bound = bound_of(grid_pairs(sp.ncells, *sp.flat[:3], sp.prd,
                                    sp.key[-1]),
                         LJ_PAIR_OPS, sp.cap * 7 * sp.buf.element_size(),
                         dtype)
        r = timed_check(f"K7 lj_column_force 32k {dtype}",
                        ck.lj_column_force, ck.lj_column_force_reference,
                        (sp.key, sp.ncells, *sp.col, sp.prd), rtol, bound)
        if dtype == torch.float32:
            out["lj_column_force"] = {
                "launches": launches["lj_column_force"], **r}
    log_walk_launch("lj_column_force", sp.ncells, sp.cc,
                    lambda dt: ck.launch_shape(sp.ncells, dt))
    edge = column_edge_checks(dev, "K7 lj_column_force", ck.lj_column_force,
                              ck.lj_column_force_reference)
    entry = out["lj_column_force"]
    entry["max_abs_err"] = max(entry["max_abs_err"], edge["max_abs_err"])
    entry["edge_checks"] = edge["checks"]
    entry["frame_max_abs_err_lj_cell_force"] = cell_force_frame_check(dev)

    # P9 on the script's inputs (times, asm_only's values) and on live ones
    sp = sorted_planes(sim)
    args = (sp.ncells, *sp.col, sp.prd)
    item = sp.buf.element_size()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def near3(a):
        u = torch.rand(a.shape, generator=gen, device=dev, dtype=a.dtype)
        return 3.0 + torch.where(u < 0.5, -1.0, 1.0) * (0.8 + 0.8 * u)

    gi = sp.col[3]
    live = (sp.ncells, *(near3(a) for a in sp.col[:3]),
            torch.remainder(torch.arange(gi.numel(), device=dev), 4).to(
                gi.dtype).reshape(gi.shape) - 1, sp.prd)
    # the rows whose pair math is live on the melt (0 <= id < FILL within
    # the cutoff of the constant candidate): the bound counts every row
    # and lane all the same, the work the ablation defines
    ref = ak.pair_only_reference(sp.key, *args)
    d2 = sum((a - ak.FILL) ** 2 for a in sp.flat[:3]).reshape(-1)
    keep = int(((sp.ids >= 0) & (sp.ids < ak.FILL)
                & (d2 < sp.key[-1])).sum())
    variants = {"asm_only": timed_check(
        "P9 asm_only 32k f32", ak.asm_only, ak.asm_only_reference, args,
        0.0, bound_of(0, 0, sp.cap * 7 * item, torch.float32))}
    log(f"[prof-ablate] pair_only on the melt: {keep} rows with 0 <= id < "
        f"{ak.FILL} within the cutoff, max|f| "
        f"{max(a.abs().max().item() for a in ref):.3e}")
    lanes = 14 * sp.cc
    for name, rtol in (("pair_only", 1e-4), ("pair_only_approx", 1e-4)):
        fn = getattr(ak, name)
        err = check_close(f"P9 {name} live f32", fn(sp.key, *live),
                          ak.pair_only_reference(sp.key, *live), rtol)
        r = timed_check(f"P9 {name} 32k f32", lambda *a, fn=fn: fn(
            sp.key, *a), lambda *a: ak.pair_only_reference(sp.key, *a),
            args, rtol, {**bound_of(sp.cap * lanes, LJ_FWD_PAIR_OPS,
                                    sp.cap * 7 * item, torch.float32),
                         "bound_work": ABLATION_BOUND})
        variants[name] = {**r, "max_abs_err": max(err, r["max_abs_err"])}
    # the body runs on every lane: twice the lanes, about twice the time
    wide = check_close("P9 pair_only live f32 at twice the lanes",
                       ak.pair_only(sp.key, *live, lanes=2 * lanes),
                       ak.pair_only_reference(sp.key, *live,
                                              lanes=2 * lanes), 1e-4)
    lane_ms = device_ms({n: (lambda n=n: ak.pair_only(sp.key, *args,
                                                      lanes=n))
                         for n in (lanes, 2 * lanes)})
    ratio = lane_ms[2 * lanes] / lane_ms[lanes]
    log(f"[prof-ablate] pair_only device time at {2 * lanes} lanes over "
        f"{lanes} (same call): {lane_ms[2 * lanes]:.4f} / "
        f"{lane_ms[lanes]:.4f} = {ratio:.3f} (at least {LANE_RATIO_MIN}); "
        f"max abs err at {2 * lanes} lanes {wide:.3e}")
    if ratio < LANE_RATIO_MIN:
        raise RuntimeError(f"pair_only: {ratio:.3f} times the time at twice "
                           "the lanes: the body does not run on every lane")
    variants["pair_only"]["lanes_ratio"] = {"lanes": [lanes, 2 * lanes],
                                            "ms": list(lane_ms.values()),
                                            "ratio": ratio}
    for name, v in variants.items():
        v["launches"] = launches[name]
    out["lj_ablate"] = {
        **{k: variants["pair_only"][k] for k in
           ("ms", "device_ms", "plain_ms", "pairs", "bound_ms", "bound_by",
            "bound_work", "library_ms")},
        "launches": sum(v["launches"] for v in variants.values()),
        "max_abs_err": max(v["max_abs_err"] for v in variants.values()),
        "variants": variants, "asm_only_sass_ldg": loads}
    return out


def phase_plane_half(dev) -> dict:
    """14. prof.plane_half.main at cells 20 and 63 (32k and 1M atoms), with
    the launches of K8 and P10 counted over both; then K8 and P10 against
    their twins and K8 against the port's full-stencil kernel, at 32k and
    1M, f32 and f64, on jittered planes, with the device times of K8, P10
    and lj_cell_force on the same inputs; and K8 against its twin and
    lj_cell_force on the 1M deck's own positions after run(200) (see
    against_full for the components where the two twins differ). Returns
    the kernel line's entries (1M f32 at the top, every size and type
    under "sizes")."""
    import torch

    from lammps_kokkos_port_tpu_torch.ops import half_kernels as hk
    from lammps_kokkos_port_tpu_torch.ops.pair_kernels import (
        lj_cell_force, lj_cell_force_reference)
    from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
    from lammps_kokkos_port_tpu_torch.prof import plane_half
    from lammps_kokkos_port_tpu_torch.prof.grid import sorted_planes

    sims = {}
    for cells in (20, 63):
        sims[cells] = lj_melt_sim(cells=cells, t_init=T_INIT, seed=SEED,
                                  dtype=torch.float32, device=dev)
        sims[cells].setup()
        p = sims[cells].nl.params
        for name, react in (("lj_plane_half", True),
                            ("lj_plane_half_fwd", False)):
            log_walk_launch(name, p.ncells, p.cell_cap,
                            lambda dt, p=p, r=react: hk.launch_shape(
                                p.ncells, dt, react=r))
    counted = {"lj_plane_half": hk.lj_plane_half_force,
               "lj_plane_half_fwd": hk.lj_plane_half_fwd}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = {cells: plane_half.main(cells=cells, device=dev, sim=sim)
           for cells, sim in sims.items()}
    launches = {k: fn.launches for k, fn in counted.items()}
    log(f"[prof-plane] plane_half.main(cells=20), (cells=63): "
        f"{time.perf_counter() - t0:.1f} s, launches {launches}, lines (ms, "
        f"graph replays) {res}")
    # the lattice start's forces cancel to f32 rounding in both kernels
    if (min(launches.values()) <= 0
            or max(r["parity col vs v3"] for r in res.values()) > 1e-3
            or not all(math.isfinite(v) for r in res.values()
                       for v in r.values())):
        raise RuntimeError(f"plane_half: launches {launches}, {res}")

    def flat3(forces):
        return torch.stack([a.reshape(-1) for a in forces])

    def against_full(label, sp, rtol, k8_ms, max_apart):
        """K8 against lj_cell_force on `sp`, each held to its twin: they
        agree wherever their twins do. A pair at the cutoff across the
        periodic box can fall on either side of it, since the two stencils
        round its shifted coordinate in opposite frames: the components
        where the twins differ are counted, at most `max_apart` of them,
        and there the kernels differ by no more than one pair's force at
        the cutoff. The max abs difference where the twins agree, the
        count, K8's device time `k8_ms` and lj_cell_force's."""
        args = (sp.key, sp.ncells, sp.cap, *sp.plane, sp.prd)
        full = (sp.key, sp.ncells, *sp.flat[:3], sp.prd)
        _, lj1, lj2, cutsq = sp.key
        r6inv = cutsq ** -3
        cut_force = abs(r6inv * (lj1 * r6inv - lj2)) / math.sqrt(cutsq)
        ref = flat3(lj_cell_force_reference(*full))
        got = flat3(lj_cell_force(*full))
        check_close(f"lj_cell_force {label}", got, ref, rtol)
        k8 = flat3(hk.lj_plane_half_force(*args))
        tol = rtol * (ref.abs().max() + ref.abs())
        twins = (flat3(hk.lj_plane_half_force_reference(*args)) - ref).abs()
        same = twins <= tol
        err = check_close(f"K8 against lj_cell_force {label}", k8[same],
                          got[same], rtol)
        apart = int((~same).sum())
        gap = (k8 - got).abs()[~same]
        worst = gap.max().item() if apart else 0.0
        if apart > max_apart or bool((gap > cut_force + tol[~same]).any()):
            raise RuntimeError(
                f"K8 against lj_cell_force {label}: {apart} components "
                f"where the twins differ (at most {max_apart}), the kernels "
                f"apart there by up to {worst:.3e} against one pair's force "
                f"at the cutoff, {cut_force:.3e}")
        full_ms = one_device_ms(lambda: lj_cell_force(*full))
        log(f"[prof-plane] {label}: K8 device time {k8_ms:.4f} ms against "
            f"the full-stencil lj_cell_force {full_ms:.4f} ms on the same "
            f"inputs ({k8_ms / full_ms:.3f}x); max abs difference "
            f"{err:.3e} where their twins agree, {apart} components where "
            f"the twins differ (pairs at the cutoff across the periodic "
            f"box; at most {max_apart}), the kernels apart there by up to "
            f"{worst:.3e} (one pair's force at the cutoff {cut_force:.3e})")
        return {"device_ms": k8_ms, "lj_cell_force_device_ms": full_ms,
                "max_abs_diff": err, "twins_differ": apart}

    sizes = {"lj_plane_half": {}, "lj_plane_half_fwd": {}}
    keep = ("max_abs_err", "device_ms", "plain_ms", "pairs", "bound_ms",
            "bound_by")
    for cells, size in ((20, "32k"), (63, "1M")):
        for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            sp = jittered_planes(sims[cells], dtype)
            tag = f"{size} {'f32' if dtype == torch.float32 else 'f64'}"
            args = (sp.key, sp.ncells, sp.cap, *sp.plane, sp.prd)
            pairs = grid_pairs(sp.ncells, *sp.flat[:3], sp.prd, sp.key[-1])
            nbytes = sp.cap * 7 * sp.buf.element_size()
            for name, kernel, plain, ops in (
                    ("lj_plane_half", hk.lj_plane_half_force,
                     hk.lj_plane_half_force_reference, LJ_PAIR_OPS),
                    ("lj_plane_half_fwd", hk.lj_plane_half_fwd,
                     hk.lj_plane_half_fwd_reference, LJ_FWD_PAIR_OPS)):
                r = timed_check(f"{'K8' if ops == LJ_PAIR_OPS else 'P10'} "
                                f"{name} {tag}", kernel, plain, args, rtol,
                                bound_of(pairs, ops, nbytes, dtype))
                sizes[name][tag] = {k: r[k] for k in keep}
            k8 = sizes["lj_plane_half"][tag]
            k8["against lj_cell_force"] = against_full(
                tag, sp, rtol, k8["device_ms"], max_apart=0)
            del sp
    # the 1M deck's own positions: the melt after run(200), no jitter; its
    # pairs at the cutoff across the box put a few components apart
    deck = sims[63]
    deck.run(200, thermo_every=200)
    sp = sorted_planes(deck)
    args = (sp.key, sp.ncells, sp.cap, *sp.plane, sp.prd)
    pairs = grid_pairs(sp.ncells, *sp.flat[:3], sp.prd, sp.key[-1])
    r = timed_check("K8 lj_plane_half 1M deck f32", hk.lj_plane_half_force,
                    hk.lj_plane_half_force_reference, args, 1e-4,
                    bound_of(pairs, LJ_PAIR_OPS,
                             sp.cap * 7 * sp.buf.element_size(),
                             torch.float32))
    sizes["lj_plane_half"]["1M deck f32"] = {
        **{k: r[k] for k in keep},
        "against lj_cell_force": against_full("1M deck f32", sp, 1e-4,
                                              r["device_ms"], max_apart=8)}
    del sims, deck, sp
    out = {}
    for name in sizes:
        top = sizes[name]["1M f32"]
        out[name] = {"launches": launches[name], "at": "1M f32",
                     "ms": top["device_ms"], **{k: top[k] for k in keep},
                     "library_ms": LIBRARY_MS, "sizes": sizes[name]}
    return out


# the column walk's SASS: plain global loads, asynchronous copies (the
# staging), shared loads (the stage) and reciprocals (the pair body)
WALK_SASS_OPS = {"LDG": r"\bLDG(?=[. ])", "LDGSTS": r"\bLDGSTS\b",
                 "LDS": r"\bLDS\b", "MUFU.RCP": r"\bMUFU\.RCP"}


def noassembly_sass() -> dict:
    """P5 noassembly must walk its NaN stage and never stage from memory:
    in each of its instances (f32, f64; the walk's Mask kUnstaged, 4) the
    SASS holds the pair loop (a reciprocal, MUFU.RCP*, and shared reads of
    the stage, LDS), no asynchronous copy (LDGSTS, the staging) and fewer
    global loads (LDG + LDGSTS) than any instance of the same type that
    stages."""
    import re

    from lammps_kokkos_port_tpu_torch.prof import column_half_kernels as chk

    fns = sass_counts(chk.SOURCE, "column_half_kernel", WALK_SASS_OPS)
    res = {}
    for kind, tag in (("f32", "f"), ("f64", "d")):
        mine, staged = [], []
        for name, c in fns.items():
            m = re.search(r"column_half_kernelI([fd]).*?4MaskE(\d+)E", name)
            if m and m.group(1) == tag:
                (mine if m.group(2) == "4" else staged).append(c)
        if len(mine) != 1 or not staged:
            raise RuntimeError(f"noassembly SASS: functions {list(fns)}")
        least = min(c["LDG"] + c["LDGSTS"] for c in staged)
        res[kind] = {**mine[0], "global loads of the staging instances "
                     "(least)": least}
        if (mine[0]["MUFU.RCP"] < 1 or mine[0]["LDS"] < 1
                or mine[0]["LDGSTS"] > 0
                or mine[0]["LDG"] + mine[0]["LDGSTS"] >= least):
            raise RuntimeError(f"noassembly {kind} SASS lacks the pair loop "
                               f"or stages: {res[kind]}")
    log(f"[build] lj_column_half noassembly SASS (cuobjdump -sass): {res}")
    return res


def phase_column_half(dev) -> dict:
    """15. The Newton-half column family: prof.kernel_iso, kernel_writeonce,
    halfv2 and zchunk `main` at cells 20, with every pass's launches
    counted over them; then each pass against its twin on jittered 32k
    planes (f32, f64; P8's forward sums and rc apart, then folded against
    lj_cell_force; noassembly all NaN, and its SASS), every z chunk a pass
    is compiled for against the same twin, `iso_full` against K8 (the same
    function on the same buffer: no component apart), each instance's
    registers, the P5 split, and P8 against K8 and lj_cell_force on the
    same inputs. Returns the kernel line's entries."""
    import torch

    from lammps_kokkos_port_tpu_torch.ops import cuda_build
    from lammps_kokkos_port_tpu_torch.ops import half_kernels as hk
    from lammps_kokkos_port_tpu_torch.ops.pair_kernels import lj_cell_force
    from lammps_kokkos_port_tpu_torch.prof import (
        column_half_kernels as chk, halfv2, kernel_iso, kernel_writeonce,
        zchunk)
    from lammps_kokkos_port_tpu_torch.prof.grid import melt_sim

    sim = melt_sim(20, dev)
    # P3 (cc32_half) belongs to phase 16's path
    passes = {n: fn for n, fn in chk.PASSES.items() if n != "cc32_half"}
    for fn in passes.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = {mod.__name__.rsplit(".", 1)[1]: mod.main(cells=20, device=dev,
                                                    sim=sim)
           for mod in (kernel_iso, kernel_writeonce, halfv2, zchunk)}
    launches = {name: fn.launches for name, fn in passes.items()}
    log(f"[prof-column] kernel_iso, kernel_writeonce, halfv2, zchunk "
        f".main(cells=20): {time.perf_counter() - t0:.1f} s, launches "
        f"{launches}, lines (ms, graph replays) {res}")
    # the lattice start's forces cancel to f32 rounding in every pass
    parity = [res["kernel_iso"]["parity vs full"],
              *(res["kernel_writeonce"][f"parity f{n}"] for n in "xyz"),
              *(res["halfv2"][f"v2 zb=2 approx={a} err"]
                for a in (False, True))]
    if (min(launches.values()) <= 0 or max(parity) > 1e-3
            or not all(math.isfinite(v) for r in res.values()
                       for v in r.values())):
        raise RuntimeError(f"column-half entry points: launches {launches}, "
                           f"{res}")
    sass = noassembly_sass()
    regs = chk.instance_registers(
        cuda_build.lib_path(chk.SOURCE).with_suffix(".log").read_text())
    log("[build] lj_column_half registers per instance (ptxas, type mask "
        "landing zb): " + "; ".join(f"{n} {r}" for n, r in regs))

    # every pass against its twin (f32, f64), each of its z chunks against
    # the same twin; then the device time of each
    out = {}
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        sp = jittered_planes(sim, dtype)
        args = (sp.key, sp.ncells, sp.cap, *sp.col, sp.prd)
        item = sp.buf.element_size()
        pairs = grid_pairs(sp.ncells, *sp.flat[:3], sp.prd, sp.key[-1])
        own = grid_pairs(sp.ncells, *sp.flat[:3], sp.prd, sp.key[-1],
                         own_cell=True)
        timed, res = {}, {}
        for name, fn in passes.items():
            label = f"{name} 32k {dtype}"
            got, ref = fn(*args), chk.reference(name, *args)
            react = chk.SPECS[name][1]["react"]
            # inputs read once, outputs written once (no scratch)
            nbytes = sp.cap * chk.bound_planes(name) * item
            if name == "iso_noassembly":
                torch.cuda.synchronize()
                if not all(bool(a.isnan().all()) for a in got):
                    raise RuntimeError(f"{label}: not all NaN")
                err, bound = 0.0, bound_of(0, 0, nbytes, dtype)
            elif name == "writeonce":
                err = max(check_close(f"{label} forward sums", got[:3],
                                      ref[:3], rtol),
                          check_close(f"{label} rc", got[3], ref[3], rtol))
                bound = bound_of(pairs, LJ_PAIR_OPS, nbytes, dtype)
            else:
                err = check_close(label, got, ref, rtol)
                # fused takes each pair of the own cell in both orders
                bound = bound_of(pairs + own if name == "zchunk_fused"
                                 else pairs, LJ_FWD_PAIR_OPS if react == "none"
                                 else LJ_PAIR_OPS, nbytes, dtype)
            timed[name] = lambda fn=fn: fn(*args)
            chunks = [zb for zb in chk.ZB[name] if zb != chk.DEFAULT_ZB]
            for zb in chunks:
                err = max(err, check_close(f"{label} zb={zb}",
                                           fn(*args, zb=zb), ref, rtol))
                if dtype == torch.float32:
                    timed[f"{name} zb={zb}"] = (
                        lambda fn=fn, zb=zb: fn(*args, zb=zb))
            res[name] = {"max_abs_err": err, "plain_ms": cuda_ms(
                lambda n=name: chk.reference(n, *args), reps=3, warmup=1),
                **bound}
        # iso_full and K8: one function on one buffer, held component by
        # component within the tolerance; no component may be apart
        plane = (sp.key, sp.ncells, sp.cap, *sp.plane, sp.prd)
        k8 = torch.stack([a.reshape(-1)
                          for a in hk.lj_plane_half_force(*plane)])
        iso = torch.stack([a.reshape(-1) for a in chk.iso_full(*args)])
        torch.cuda.synchronize()
        tol = rtol * (k8.abs().max() + k8.abs())
        apart = int(((iso - k8).abs() > tol).sum())
        gap = (iso - k8).abs().max().item()
        log(f"[prof-column] iso_full against K8 (lj_plane_half_force) 32k "
            f"{dtype}, same planes: {apart} of {iso.numel()} components "
            f"apart beyond rtol {rtol:g} (atol rtol*max), max abs "
            f"difference {gap:.3e}")
        if apart:
            raise RuntimeError(f"iso_full against K8 {dtype}: {apart} "
                               "components apart")
        res["iso_full"]["against_k8"] = {"components_apart": apart,
                                         "max_abs_diff": gap}
        timed["K8 lj_plane_half_force"] = lambda: hk.lj_plane_half_force(
            *plane)
        if dtype == torch.float32:
            # P8 against the full stencil, on the same inputs
            full = lj_cell_force(sp.key, sp.ncells, *sp.flat[:3], sp.prd)
            res["writeonce"]["folded_vs_lj_cell_force"] = check_close(
                "writeonce folded against lj_cell_force 32k f32",
                [a.reshape(-1) for a in chk.wo_half_force(*args)],
                [a.reshape(-1) for a in full], rtol)
            timed.update({
                "P8 pass + torch.roll fold (wo_half_force)":
                    lambda: chk.wo_half_force(*args),
                "lj_cell_force": lambda: lj_cell_force(
                    sp.key, sp.ncells, *sp.flat[:3], sp.prd)})
        ms = device_ms(timed)
        log(f"[prof-column] 32k {dtype}, device time per call (ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
        for name, r in res.items():
            r["ms"] = r["device_ms"] = ms[name]
            log(f"[kernel] {name} 32k {dtype}: max abs err "
                f"{r['max_abs_err']:.3e} (rtol {rtol:g}, atol {rtol:g}*max"
                f"{'; every output NaN' if name == 'iso_noassembly' else ''}"
                f"), device {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"{r['pairs']} pairs, bound {r['bound_ms']:.4g} ms "
                f"({r['bound_by']})")
            if dtype == torch.float32:
                # the default launch is the chunk of DEFAULT_ZB cells
                out[name] = {"launches": launches[name], "at": "32k f32",
                             **r, "ms_by_zb": {
                                 zb: ms[name if zb == chk.DEFAULT_ZB
                                        else f"{name} zb={zb}"]
                                 for zb in chk.ZB[name]}}
            else:
                out[name]["f64"] = {k: r[k] for k in (
                    "max_abs_err", "ms", "device_ms", "plain_ms")}
        k8_key = "k8_ms" if dtype == torch.float32 else "k8_ms_f64"
        out["iso_full"][k8_key] = ms["K8 lj_plane_half_force"]
        if dtype == torch.float32:
            same = {k: ms[k] for k in (
                "writeonce", "P8 pass + torch.roll fold (wo_half_force)",
                "K8 lj_plane_half_force", "lj_cell_force")}

    # the P5 split (f32), the TPU script's differences; on the walk,
    # noassembly walks every slot unpruned and lands a reaction for each,
    # so full - noassembly is no longer the staging's cost
    t = {m: out[f"iso_{m}"]["ms"] for m in kernel_iso.MODES}
    split = {"reaction landing (full - redonly)":
             t["full"] - t["redonly"],
             "own block's reactions (redonly - noreverse)":
             t["redonly"] - t["noreverse"],
             "full - noassembly": t["full"] - t["noassembly"],
             "noreverse - noassembly": t["noreverse"] - t["noassembly"]}
    log("[prof-column] P5 split at 32k f32 (ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    out["iso_full"]["split"] = split
    out["iso_full"]["registers"] = regs
    out["writeonce"]["same_inputs_ms"] = same
    out["iso_noassembly"]["sass"] = sass
    return out


def phase_last_sites(dev) -> dict:
    """16. prof.kernel_cc32, kernel_v3, dynslice and zwin_proto `main` at
    the 32k melt (cells 20), with the launches of P3, P4, P6 k1 (P7's
    instance too), P6 k2, P1 and P12 counted over them; then each against
    its plain version: P3, P6 k1 and k2 on jittered 32k planes (f32, f64;
    P3 also against lj_cell_force and K8, k1 and k2 against each other and
    K7,
    and with a pad inside the cutoff of a real row, which k1 and k2 must
    skip and K7 takes), P4 on inputs where its pair math is live (as phase
    13 holds P9), P1 in both modes at G = 512 and 128 (f32, f64), P12 on
    the script's inputs (f32; each element within 1e-4 of the sum of the
    magnitudes of its terms, and a planted fault must fail that check),
    and the device time of each. Returns the kernel line's entries."""
    import torch

    from lammps_kokkos_port_tpu_torch.ops import column_kernels as ck
    from lammps_kokkos_port_tpu_torch.ops import half_kernels as hk
    from lammps_kokkos_port_tpu_torch.ops.pair_kernels import lj_cell_force
    from lammps_kokkos_port_tpu_torch.prof import ablate_kernels as ak
    from lammps_kokkos_port_tpu_torch.prof import column_half_kernels as chk
    from lammps_kokkos_port_tpu_torch.prof import dynslice_kernels as dk
    from lammps_kokkos_port_tpu_torch.prof import v3_kernels as v3k
    from lammps_kokkos_port_tpu_torch.prof import zwin_kernels as zk
    from lammps_kokkos_port_tpu_torch.prof import (dynslice, kernel_cc32,
                                                   kernel_v3, zwin_proto)
    from lammps_kokkos_port_tpu_torch.prof.grid import melt_sim

    sim = melt_sim(20, dev)
    counted = {"lj_column_half_cc32_half": chk.cc32_half,
               "lj_ablate_pair512": ak.pair_only,
               "lj_column_v3_k1": v3k.v3_k1, "lj_column_v3_k2": v3k.v3_k2,
               "dynslice": dk.dynslice, "zwin_proto": zk.zwin_proto}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = {"kernel_cc32": kernel_cc32.main(cells=20, device=dev, sim=sim),
           "kernel_v3": kernel_v3.main(cells=20, device=dev, sim=sim),
           "dynslice": dynslice.main(device=dev),
           "zwin_proto": zwin_proto.main(cells=20, device=dev, sim=sim)}
    launches = {k: fn.launches for k, fn in counted.items()}
    log(f"[prof-last] kernel_cc32, kernel_v3, dynslice, zwin_proto "
        f".main(cells=20): {time.perf_counter() - t0:.1f} s, launches "
        f"{launches}, lines (ms, graph replays) {res}")
    if min(launches.values()) <= 0 or not all(
            math.isfinite(v) for r in res.values() for v in r.values()):
        raise RuntimeError(f"last sites: launches {launches}, {res}")

    out = {name: {"launches": n, "at": "32k f32"}
           for name, n in launches.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        sp = jittered_planes(sim, dtype)
        item = sp.buf.element_size()
        pairs = grid_pairs(sp.ncells, *sp.flat[:3], sp.prd, sp.key[-1])
        col = (sp.key, sp.ncells, *sp.col, sp.prd)
        half = (sp.key, sp.ncells, sp.cap, *sp.col, sp.prd)
        nbytes = sp.cap * 7 * item
        checked, timed, plain = {}, {}, {}
        # P3, against its twin, the full stencil and K8 (with no pad near
        # a real row, K8's function on the same buffer)
        full = [a.reshape(-1) for a in lj_cell_force(sp.key, sp.ncells,
                                                     *sp.flat[:3], sp.prd)]
        k8 = [a.reshape(-1) for a in hk.lj_plane_half_force(
            sp.key, sp.ncells, sp.cap, *sp.plane, sp.prd)]
        got = chk.cc32_half(*half)
        checked["lj_column_half_cc32_half"] = (max(
            check_close(f"P3 cc32_half 32k {dtype}", got,
                        chk.reference("cc32_half", *half), rtol),
            check_close(f"P3 against lj_cell_force 32k {dtype}",
                        [a.reshape(-1) for a in got], full, rtol),
            check_close(f"P3 against K8 32k {dtype}",
                        [a.reshape(-1) for a in got], k8, rtol)),
            bound_of(pairs, LJ_PAIR_OPS,
                     sp.cap * chk.bound_planes("cc32_half") * item, dtype))
        timed["lj_column_half_cc32_half"] = lambda: chk.cc32_half(*half)
        plain["lj_column_half_cc32_half"] = lambda: chk.reference(
            "cc32_half", *half)
        # P6 k1 and k2: their twins, each other, K7
        k7 = ck.lj_column_force(*col)
        k1 = v3k.v3_k1(*col)
        for name, fn, grouped in (("lj_column_v3_k1", v3k.v3_k1, False),
                                  ("lj_column_v3_k2", v3k.v3_k2, True)):
            got = fn(*col)
            checked[name] = (max(
                check_close(f"P6 {name} 32k {dtype}", got,
                            v3k.v3_reference(*col, grouped=grouped), rtol),
                check_close(f"P6 {name} against K7 32k {dtype}", got, k7,
                            rtol),
                check_close(f"P6 {name} against k1 32k {dtype}", got, k1,
                            rtol)),
                bound_of(pairs, LJ_PAIR_OPS, nbytes, dtype))
            timed[name] = lambda fn=fn: fn(*col)
            plain[name] = lambda g=grouped: v3k.v3_reference(*col, grouped=g)
        # P6's candidate mask (cand_id >= 0), which the melt cannot show
        # (its pads die by distance): a cell's second row made a pad 0.84
        # from its first; k1 and k2 must skip it, K7 takes it
        pcol = tuple(a.clone() for a in sp.col)
        flat = [a.reshape(-1) for a in pcol]
        real = int(torch.nonzero(flat[3] >= 0)[0])
        flat[3][real + 1] = -1.0
        for d in range(3):
            flat[d][real + 1] = flat[d][real] + (0.84 if d == 0 else 0.0)
        pargs = (sp.key, sp.ncells, *pcol, sp.prd)
        k7_pad = ck.lj_column_force(*pargs)
        check_close(f"K7 with a live pad {dtype}", k7_pad,
                    ck.lj_column_force_reference(*pargs), rtol)
        k7_pad = k7_pad[0].reshape(-1)[real].item()
        for name, fn, grouped in (("lj_column_v3_k1", v3k.v3_k1, False),
                                  ("lj_column_v3_k2", v3k.v3_k2, True)):
            got = fn(*pargs)
            err = check_close(f"P6 {name} with a live pad {dtype}", got,
                              v3k.v3_reference(*pargs, grouped=grouped), rtol)
            fx = got[0].reshape(-1)[real].item()
            log(f"[prof-last] {name} {dtype} with a pad 0.84 from a real "
                f"row: fx {fx:.6g} there (K7, which takes the pad: "
                f"{k7_pad:.6g}), max abs err {err:.3e}")
            if abs(fx - k7_pad) <= 1.0:
                raise RuntimeError(f"{name}: the pad acted on a real row")
            checked[name] = (max(checked[name][0], err), checked[name][1])
        # P4: 512 lanes, on live inputs and the melt's (its timed inputs)
        gi = sp.col[3]
        live = tuple(3.0 + torch.where(u < 0.5, -1.0, 1.0) * (0.8 + 0.8 * u)
                     for u in (torch.rand(a.shape, generator=gen, device=dev,
                                          dtype=dtype) for a in sp.col[:3]))
        ids = torch.remainder(torch.arange(gi.numel(), device=dev), 4).to(
            dtype).reshape(gi.shape) - 1
        melt = (sp.key, sp.ncells, *sp.col, sp.prd)
        checked["lj_ablate_pair512"] = (max(
            check_close(f"P4 pair_only lanes=512 live {dtype}",
                        ak.pair_only(sp.key, sp.ncells, *live, ids, sp.prd,
                                     lanes=512),
                        ak.pair_only_reference(sp.key, sp.ncells, *live, ids,
                                               sp.prd, lanes=512), rtol),
            check_close(f"P4 pair_only lanes=512 32k {dtype}",
                        ak.pair_only(*melt, lanes=512),
                        ak.pair_only_reference(*melt, lanes=512), rtol)),
            {**bound_of(sp.cap * 512, LJ_FWD_PAIR_OPS, nbytes, dtype),
             "bound_work": ABLATION_BOUND})
        timed["lj_ablate_pair512"] = lambda: ak.pair_only(*melt, lanes=512)
        plain["lj_ablate_pair512"] = lambda: ak.pair_only_reference(
            *melt, lanes=512)
        # P1: both modes at both G
        starts = dynslice.script_starts(dev)
        errs = []
        for g in (dynslice.G, dynslice.W):
            ext = torch.randn((dynslice.NCOL, g), generator=gen, device=dev,
                              dtype=dtype)
            for mode in dk.MODES:
                errs.append(check_close(
                    f"P1 dynslice {mode} G={g} {dtype}",
                    dk.dynslice(starts, ext, dynslice.W, mode),
                    dk.dynslice_reference(starts, ext, dynslice.W, mode),
                    rtol))
                timed[f"dynslice {mode} G={g}"] = (
                    lambda e=ext, m=mode: dk.dynslice(starts, e, dynslice.W,
                                                      m))
        ext = torch.ones((dynslice.NCOL, dynslice.G), device=dev, dtype=dtype)
        nch = starts.shape[1]
        p1_bytes = (starts.numel() * 4 + ext.numel() * item
                    + dynslice.NCOL * dynslice.W * item)
        checked["dynslice"] = (max(errs), {
            **bound_of(dynslice.NCOL * dynslice.W * (nch + 1), 1, p1_bytes,
                       dtype), "pairs": None})
        timed["dynslice"] = lambda: dk.dynslice(starts, ext, dynslice.W)
        plain["dynslice"] = lambda: dk.dynslice_reference(starts, ext,
                                                          dynslice.W)
        # P12 (f32 only: the approximate reciprocal)
        if dtype == torch.float32:
            zin = zk.zwin_inputs(device=dev)
            zpairs = zk.pairs_in_cutoff(*zin)
            zbytes = sum(a.numel() * a.element_size() for a in zin) * 2 - (
                zin[-1].numel() * 4)
            zref = zk.zwin_reference(*zin)
            zmax = max(a.abs().max().item() for a in zref)
            # uniform random points: a few near-coincident pairs give forces
            # up to r^-13, so an atol scaled by max|ref| would pass a wrong
            # window; each element is held to the sum of the magnitudes of
            # its own terms instead, and a planted fault (every window start
            # moved by one) must fail that check
            scale = zk.zwin_reference(*zin, magnitude=True)
            zgot = zk.zwin_proto(*zin)
            moved = zk.zwin_proto(*zin[:-1], zin[-1] + 1)
            scaled = zk.max_scaled_error(zgot, zref, scale)
            planted = zk.max_scaled_error(moved, zref, scale)
            zerr = max((a - b).abs().max().item() for a, b in zip(zgot, zref))
            log(f"[prof-last] P12 on the script's inputs: {zpairs} pairs in "
                f"the cutoff, max|ref| {zmax:.6g}, max abs err {zerr:.3e}; "
                f"max |err| / (sum of |terms|) {scaled:.3e} (limit 1e-4), "
                f"with the starts moved by one {planted:.3g} (must exceed "
                f"0.1)")
            if not (all(bool(torch.isfinite(a).all()) for a in zgot)
                    and scaled <= 1e-4 and planted > 0.1):
                raise RuntimeError(f"P12 zwin_proto f32: scaled error "
                                   f"{scaled}, planted fault {planted}")
            checked["zwin_proto"] = (zerr, {
                **bound_of(zpairs, LJ_PAIR_OPS, zbytes, dtype,
                           row_ops=ZWIN_TEST_OPS * zk.ZwinShape().lane_pairs),
                "bound_work": ZWIN_BOUND})
            timed["zwin_proto"] = lambda: zk.zwin_proto(*zin)
            plain["zwin_proto"] = lambda: zk.zwin_reference(*zin)
            timed["lj_cell_force"] = lambda: lj_cell_force(
                sp.key, sp.ncells, *sp.flat[:3], sp.prd)
        ms = device_ms(timed)
        log(f"[prof-last] 32k {dtype}, device time per call (ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
        for name, (err, bound) in checked.items():
            r = {"max_abs_err": err, "ms": ms[name], "device_ms": ms[name],
                 "plain_ms": cuda_ms(plain[name], reps=3, warmup=1), **bound}
            limit = ("1e-4 of each element's sum of |terms|"
                     if name == "zwin_proto" else f"rtol {rtol:g}, atol "
                     "rtol*max")
            log(f"[kernel] {name} 32k {dtype}: max abs err {err:.3e} "
                f"({limit}), device {r['device_ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, {bound['pairs']} pairs, bound "
                f"{bound['bound_ms']:.4g} ms ({bound['bound_by']})")
            if dtype == torch.float32:
                out[name].update(r)
            else:
                out[name]["f64"] = {k: r[k] for k in (
                    "max_abs_err", "ms", "device_ms", "plain_ms")}
        if dtype == torch.float32:
            out["dynslice"]["ms_by_shape"] = {
                k: v for k, v in ms.items() if k.startswith("dynslice ")}
            out["zwin_proto"]["lj_cell_force_device_ms"] = ms["lj_cell_force"]
            out["zwin_proto"]["max_abs_ref"] = zmax
            out["zwin_proto"]["max_scaled_err"] = scaled
    out["dynslice"]["library_note"] = (
        "no single PyTorch call: a gather, a sum over the windows and a "
        "scale")
    out["lj_column_v3_k1"]["also_replaces"] = [P7_SITE]
    for name, label, fn, grouped in (
            ("lj_column_v3_k1", "P6 k1 (P7)", v3k.v3_k1, False),
            ("lj_column_v3_k2", "P6 k2", v3k.v3_k2, True)):
        edge = column_edge_checks(
            dev, f"{label} {name}", fn,
            lambda *a, g=grouped: v3k.v3_reference(*a, grouped=g))
        entry = out[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], edge["max_abs_err"])
        entry["edge_checks"] = edge["checks"]
    return out


def rank(kernels: list, decks: list) -> None:
    """The redesign queue's order, as two lines. First any kernel slower
    than its library call. `[rank]`: the decks' kernels, each by its
    launches per step of a deck's run times its device time above its bound
    at that deck's size, summed over one step of each deck it serves
    (`decks`: (kernel, deck, launches per step, entry at that size)).
    `[rank-prof]`: the kernels only the profiling entry points run, one
    call each (device_ms - bound_ms at the size of their entry): their
    launch counts follow the timers' iteration counts, not any traffic."""
    slower = [e["name"] for e in kernels if e["library_ms"] is not None
              and e["device_ms"] > e["library_ms"]]
    log(f"[rank] slower than their library call: {slower or 'none'} "
        f"({sum(e['library_ms'] is None for e in kernels)} of "
        f"{len(kernels)} kernels have no library call)")
    per = {}
    for name, deck, per_step, e in decks:
        per.setdefault(name, []).append(
            (deck, per_step, per_step * (e["device_ms"] - e["bound_ms"])))
    log("[rank] decks' kernels, launches per step x (device_ms - bound_ms)"
        " at the deck's size, ms per step of each deck ([redesigned]: "
        "REDESIGNED, on the shared candidate walk or with more rows in "
        "flight): " + "; ".join(
            f"{name}{' [redesigned]' if name in REDESIGNED else ''} "
            f"{sum(t[2] for t in terms):.4f} (" + ", ".join(
                f"{deck} {n:.3f} x -> {v:.4f}" for deck, n, v in terms) + ")"
            for name, terms in sorted(
                per.items(), key=lambda kv: -sum(t[2] for t in kv[1]))))
    prof = sorted(((e["device_ms"] - e["bound_ms"], e["name"],
                    e.get("at", "32k f32")) for e in kernels
                   if e["name"] not in per), reverse=True)
    log("[rank-prof] profiling-only kernels, one call each, device_ms - "
        "bound_ms, ms ([redesigned] as above): " + ", ".join(
            f"{name}{' [redesigned]' if name in REDESIGNED else ''} "
            f"{v:.4f} ({at})"
            for v, name, at in prof))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lammps_kokkos_port_tpu_torch.io.eam_reader import (
        write_sutton_chen_funcfl)
    from lammps_kokkos_port_tpu_torch import cli
    from lammps_kokkos_port_tpu_torch.ops import (cell_kernels, cellforce,
                                                  column_kernels, cuda_build,
                                                  eam_kernels, eamdense,
                                                  half_kernels, pair_kernels,
                                                  sortedforce)
    from lammps_kokkos_port_tpu_torch.ops.eamdense import embedding_fp
    from lammps_kokkos_port_tpu_torch.prof import (ablate_kernels,
                                                   column_half_kernels,
                                                   dynslice_kernels,
                                                   zwin_kernels)
    from lammps_kokkos_port_tpu_torch.script import LammpsScript
    from lammps_kokkos_port_tpu_torch.presets import (eam_bulk_cu_sim,
                                                      lj_melt_sim)

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
    build_logs = cuda_build.build(pair_kernels.SOURCE, eam_kernels.SOURCE,
                                  cell_kernels.SOURCE, column_kernels.SOURCE,
                                  half_kernels.SOURCE, ablate_kernels.SOURCE,
                                  column_half_kernels.SOURCE,
                                  dynslice_kernels.SOURCE,
                                  zwin_kernels.SOURCE)
    log(f"[build] nvcc, {len(build_logs)} sources in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "stack frame", "warning")):
                log(f"[build] {src}: {line.strip()}")

    # 2. kernel vs plain at the main path's grids
    t0 = time.perf_counter()
    sim32 = lj_melt_sim(cells=20, t_init=T_INIT, seed=SEED,
                        dtype=torch.float32, device=dev)
    sim32.setup()
    sim1m = lj_melt_sim(cells=63, t_init=T_INIT, seed=SEED,
                        dtype=torch.float32, device=dev)
    sim1m.setup()
    log(f"[setup] 32k + 1M decks {time.perf_counter() - t0:.1f} s")
    for deck in (sim32, sim1m):
        p = deck.nl.params
        log_walk_launch("lj_cell_force", p.ncells, p.cell_cap,
                        lambda dt, p=p: pair_kernels.launch_shape(p.ncells,
                                                                  dt))
    main_cell = kernel_vs_plain(sim32, torch.float32, "32k f32")
    kernel_vs_plain(sim32, torch.float64, "32k f64")
    main_cell_1m = kernel_vs_plain(sim1m, torch.float32, "1M f32")
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
    launches_1m = pair_kernels.lj_cell_force.launches
    log(f"[lj-1m] run(200): {launches_1m} kernel launches, loop "
        f"{sim1m.last_loop_time:.3f} s, grid {sim1m.nl.params.ncells} x cc "
        f"{sim1m.nl.params.cell_cap}")
    if launches_1m <= 0:
        raise RuntimeError("1M deck never launched the kernel")
    check_run(sim1m, rows, "lj-1m")
    step_1m = step_rate(sim1m, 20, "lj-1m")
    profile_segment(sim1m, 20, step_1m, "lj-1m", ("lj_cell_force",),
                    {"rebin": [(sortedforce, "rebuild_state")]})
    kernel_on_deck_state(sim1m, "lj-1m")

    # 6.-8. the EAM deck on the synthetic Sutton-Chen stand-in
    with tempfile.TemporaryDirectory() as tmp:
        pot = write_sutton_chen_funcfl(os.path.join(tmp, "sc.eam"))
        t0 = time.perf_counter()
        eam = eam_bulk_cu_sim(cells=20, dtype=torch.float32, device=dev,
                              potential_path=pot, list_mode="sorted")
        eam.setup()
        eam64 = eam_bulk_cu_sim(cells=20, dtype=torch.float64, device=dev,
                                potential_path=pot, list_mode="sorted")
        eam64.setup()
        cc = eam.nl.params.cell_cap
        log(f"[setup] eam-32k f32 + f64 decks {time.perf_counter() - t0:.1f}"
            f" s, grid {eam.nl.params.ncells} x cc {cc}")
        eam_cells = eam_kernels_vs_plain(eam, torch.float32, "eam-32k f32")
        eam_kernels_vs_plain(eam64, torch.float64, "eam-32k f64")
        del eam64
        # 6b. the same at the 1M EAM grid (one f32 deck; f64 from its
        # positions), the plain versions timed over fewer calls
        t0 = time.perf_counter()
        eam1m = eam_bulk_cu_sim(cells=63, dtype=torch.float32, device=dev,
                                potential_path=pot, list_mode="sorted")
        eam1m.setup()
        p1m = eam1m.nl.params
        log(f"[setup] eam-1m f32 deck {time.perf_counter() - t0:.1f} s, "
            f"{eam1m.state.nlocal} atoms, grid {p1m.ncells} x cc "
            f"{p1m.cell_cap}")
        for deck in (eam, eam1m):
            for name in ("eam_cell_rho", "eam_cell_force"):
                log_walk_launch(name, deck.nl.params.ncells,
                                deck.nl.params.cell_cap,
                                lambda dt, n=name, d=deck: (
                                    eam_kernels.launch_shape(
                                        n, d.nl.params.ncells, dt)))
        eam_1m = eam_kernels_vs_plain(eam1m, torch.float32, "eam-1m f32",
                                      plain_reps=2)
        eam_kernels_vs_plain(eam1m, torch.float64, "eam-1m f64", plain_reps=2)
        del eam1m
        for name, entry in eam_1m.items():
            eam_cells[name]["at_1m"] = {k: entry[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
        eam_card_vs_cpu(pot)

        # 8. the EAM main path: counted launches over the run
        params0 = eam.nl.params
        eam_kernels.eam_cell_rho.launches = 0
        eam_kernels.eam_cell_force.launches = 0
        rows = eam.run(EAM_STEPS, thermo_every=50)
        eam_launches = {"eam_cell_rho": eam_kernels.eam_cell_rho.launches,
                        "eam_cell_force": eam_kernels.eam_cell_force.launches}
    log(f"[eam-32k] run({EAM_STEPS}): launches {eam_launches}, nbuilds "
        f"{eam.nl.nbuilds}, loop {eam.last_loop_time:.3f} s incl. "
        f"{len(rows)} thermo rows, grid {eam.nl.params.ncells} x cc "
        f"{eam.nl.params.cell_cap}")
    n_rho, n_force = eam_launches.values()
    # one launch of each per force step; an overflow retry (the grid grew)
    # re-runs a segment's steps
    if n_rho != n_force or n_rho < EAM_STEPS or (
            n_rho != EAM_STEPS and eam.nl.params == params0):
        raise RuntimeError(f"EAM kernels not launched once per force step: "
                           f"{eam_launches} over {EAM_STEPS} steps")
    if eam.nl.nbuilds <= 1:
        raise RuntimeError("EAM run made no distance-checked rebuild")
    check_run(eam, rows, "eam-32k", bound=EAM_DRIFT_BOUND)
    eam_step = step_rate(eam, 50, "eam-32k")
    eam_kernels_pair = ("eam_cell_rho", "eam_cell_force")
    rebin = {"rebin": [(sortedforce, "needs_rebuild"),
                       (sortedforce, "rebuild_if")]}
    glue_calls = []

    def no_glue(*args, **kwargs):
        glue_calls.append(1)
        return embedding_fp(*args, **kwargs)

    # the fp glue is the rho sweep's epilogue: embedding_fp is not called
    with replaced([(eam_kernels, "embedding_fp", no_glue),
                   (eamdense, "embedding_fp", no_glue)]):
        fused = profile_segment(eam, 50, eam_step, "eam-32k",
                                eam_kernels_pair, rebin)
    if glue_calls:
        raise RuntimeError(f"eam-32k: embedding_fp called {len(glue_calls)}"
                           " times in the profiled segment on the card")
    # the same deck through the earlier chain, for the before-and-after
    with replaced([(eam_kernels, "compute_force_sorted",
                    unfused_force_sorted)]):
        unfused_step = step_rate(eam, 50, "eam-32k unfused chain")
        unfused = profile_segment(
            eam, 50, unfused_step, "eam-32k unfused chain", eam_kernels_pair,
            {**rebin, "fp glue": [(eamdense, "embedding_fp")]})
    log(f"[eam-32k device ops per step] unfused chain (rho sweep, "
        f"embedding_fp, force sweep) {unfused['ops_per_step']:.1f} -> fused "
        f"{fused['ops_per_step']:.1f}; device busy "
        f"{unfused['busy_ms']:.4f} -> {fused['busy_ms']:.4f} ms per step; "
        f"host {unfused_step * 1e3:.4f} -> {eam_step * 1e3:.4f} ms per step "
        f"(embedding_fp calls in the fused segment: {len(glue_calls)})")
    del sim32, sim1m, gold, eam

    with tempfile.TemporaryDirectory() as tmp:
        # 9. the input-deck slice: 1M in.lj through LammpsScript, cell mode
        script, cell_launches = deck_1m_cell(tmp)
        sim = script.sim
        log_walk_launch("lj_cell_dense", sim.nl.params.ncells,
                        sim.nl.params.cell_cap,
                        lambda dt, p=sim.nl.params: cell_kernels.launch_shape(
                            p.total_cells, dt))
        cell_step = step_rate(sim, 20, "lj-1m-cell")
        profile_segment(sim, 40, cell_step, "lj-1m-cell", ("lj_cell_dense",),
                        {"rebin": [(cellforce, "rebuild_merge")]})

        # 10. the cell kernel against its plain version: the 1M deck's grid
        # (its state after the run) and the 32k deck's (jittered lattice)
        main_dense = cell_kernel_vs_plain(sim, torch.float32, "1M-cell f32",
                                          jitter=0.0)
        cell_kernel_vs_plain(sim, torch.float64, "1M-cell f64", jitter=0.0)
        del script, sim
        sim32c = lj_melt_sim(cells=20, t_init=T_INIT, seed=SEED,
                             dtype=torch.float32, device=dev, list_mode="cell")
        sim32c.setup()
        cell_kernel_vs_plain(sim32c, torch.float32, "32k-cell f32", jitter=0.1)
        cell_kernel_vs_plain(sim32c, torch.float64, "32k-cell f64", jitter=0.1)
        del sim32c

        # 11. the 32k deck through the command line, default mode (sorted)
        path = os.path.join(tmp, "in.lj")
        pair_kernels.lj_cell_force.launches = 0
        t0 = time.perf_counter()
        if cli.main(["-in", path, "-device", "cuda"]) != 0:
            raise RuntimeError("cli: non-zero return")
        cli_launches = pair_kernels.lj_cell_force.launches
        log(f"[cli-32k] cli.main -in in.lj -device cuda: "
            f"{time.perf_counter() - t0:.3f} s, {cli_launches} lj kernel "
            f"launches")
        if cli_launches < 1 + DECK_STEPS:
            raise RuntimeError(f"cli-32k: {cli_launches} lj kernel launches "
                               f"for {DECK_STEPS} steps")

        # 12. examples/melt in f64: the card against the CPU, and golden
        path = os.path.join(tmp, "in.melt")
        Path(path).write_text(MELT_DECK)
        melt = {d: run_deck(LammpsScript(dtype=torch.float64, device=d),
                            path)[0] for d in ("cuda", "cpu")}
    for a, b in zip(melt["cuda"], melt["cpu"], strict=True):
        for k in ("temp", "epair", "etotal", "press"):
            if not math.isclose(a[k], b[k], rel_tol=1e-10):
                raise RuntimeError(f"melt deck card vs cpu, step {a['step']} "
                                   f"{k}: {a[k]!r} vs {b[k]!r}")
    row0 = melt["cuda"][0]
    log(f"[melt-deck] f64, card and CPU rows agree at rel 1e-10 (steps "
        f"{[r['step'] for r in melt['cuda']]}); step 0 epair "
        f"{row0['epair']:.10f} (log -6.7733681)")
    if abs(row0["epair"] + 6.7733681) > 2e-7 or len(melt["cuda"]) != 2:
        raise RuntimeError(f"melt deck step 0 mismatch: {row0}")

    # 13.-16. the profiling entry points and their kernels
    prof = phase_sorted_ablate(dev)
    prof.update(phase_plane_half(dev))
    column = phase_column_half(dev)
    last = phase_last_sites(dev)

    kernels = [
        {"name": "lj_cell_force", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "also_replaces": ALSO_REPLACES,
         "launches": launches, **main_cell},
        *({"name": name, "route": "cuda", "source": EAM_SOURCE,
           "replaces": EAM_REPLACES[name], "launches": eam_launches[name],
           **eam_cells[name]} for name in ("eam_cell_rho", "eam_cell_force")),
        {"name": "lj_cell_dense", "route": "cuda", "source": CELL_SOURCE,
         "replaces": CELL_REPLACES, "launches": cell_launches, **main_dense},
        *({"name": name, "route": "cuda", "source": source,
           "replaces": PROF_REPLACES[name], **prof[name]}
          for name, source in (("lj_column_force", COLUMN_SOURCE),
                               ("lj_plane_half", HALF_SOURCE),
                               ("lj_ablate", ABLATE_SOURCE),
                               ("lj_plane_half_fwd", HALF_SOURCE))),
        *({"name": f"lj_column_half_{name}", "route": "cuda",
           "source": COLUMN_HALF_SOURCE,
           "replaces": COLUMN_HALF_REPLACES[name.split("_")[0]], **entry}
          for name, entry in column.items()),
        *({"name": name, "route": "cuda", "source": LAST_SITES[name][0],
           "replaces": LAST_SITES[name][1], **entry}
          for name, entry in last.items()),
    ]
    rank(kernels, [
        ("lj_cell_force", "lj-32k", launches / 1000, main_cell),
        ("lj_cell_force", "lj-1m", launches_1m / 200, main_cell_1m),
        *((name, "eam-32k", eam_launches[name] / EAM_STEPS, eam_cells[name])
          for name in ("eam_cell_rho", "eam_cell_force")),
        ("lj_cell_dense", "lj-1m-cell", cell_launches / DECK_STEPS,
         main_dense)])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
