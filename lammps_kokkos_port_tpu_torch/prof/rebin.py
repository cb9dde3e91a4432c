"""Device time of the sorted layout's re-bin kernels at the 1M grids, on the
card.

    python -m lammps_kokkos_port_tpu_torch.prof.rebin --out <file>

At the 1M Tersoff grid (bench/POTENTIALS/in.tersoff at -var x 4 -var y 2
-var z 4: 1,024,000 atoms, 100 x 48 x 48 cells of 16) and the 1M EAM grid
(bench/in.eam's preset at cells 63 on the Sutton-Chen stand-in: 1,000,188
atoms, 37 x 37 x 37 cells of 32, re-sorted at 48: its setup leaves full
cells, which a jitter overflows), in float32 and float64: the sorted state
after setup as a segment holds it (`sortedforce.segment_copies`), positions
jittered by a seeded +-JITTER of a cell edge (atoms cross cells and the
box's faces). Each kernel of ops/rebin_kernels is timed by its own device
time in torch.profiler traces (by kernel name), on a step that rebuilds
(the flag set) and on one that does not; the plain versions a call by CUDA
events (`needs_rebuild_reference`, and `rebuild_if_reference`, which does
the same work whatever the flag); each kernel's bound, the bytes of a
rebuild step over 3.35 TB/s. One JSON line a case; `--out` also writes them
as a JSON list. chip_smoke.py holds the kernels against the plain versions
at the same grids.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import tempfile
import time
from pathlib import Path

import torch

from ..ops import rebin_kernels as rk
from ..ops import sortedforce as sf
from . import redesign
from .timing import say

ROUNDS = 3
INNER = 20
JITTER = 0.2     # of a cell edge, each way
HBM_BYTES_S = 3.35e12
# rows of room added to a cell: the EAM grid (37^3 cells of 32) has full
# cells at setup, which any jitter overflows
SLACK = {"tersoff-1m": 0, "eam-1m": 16}
AGO = 10  # steps since the last rebuild: on the cadence of `delay 5 every 1`


def tersoff_1m(dtype, device="cuda"):
    from .tersoff import deck_sim

    return deck_sim(dtype, "1m", device)


def eam_1m(dtype, potential_dir: str, device="cuda"):
    from ..io.eam_reader import write_sutton_chen_funcfl
    from ..presets import eam_bulk_cu_sim

    pot = write_sutton_chen_funcfl(str(Path(potential_dir) / "sc.eam"))
    sim = eam_bulk_cu_sim(cells=63, dtype=dtype, device=device,
                          potential_path=pot, list_mode="sorted")
    sim.setup()
    return sim


def segment_state(sim, dtype, slack: int = 0, jitter: float = JITTER,
                  seed: int = 17):
    """The sim's sorted state and list as a segment holds them, cast to
    `dtype` (and re-sorted with `slack` more rows a cell where asked), the
    valid rows moved by a seeded +-jitter of a cell edge; `ago` on the
    cadence of a `delay 5 every 1` deck."""
    st, nl = sim.state, sim.nl
    st = st.replace(x=st.x.to(dtype), v=st.v.to(dtype), f=st.f.to(dtype),
                    q=None if st.q is None else st.q.to(dtype),
                    box=st.box.to(dtype=dtype))
    if slack:
        p = dataclasses.replace(nl.params,
                                cell_cap=nl.params.cell_cap + slack)
        st, nl = sf.build(sf.expand_state(st, p), p, nl.short_cap)
    nl = dataclasses.replace(nl, ago=AGO, xhold=st.x.clone())
    st, nl = sf.segment_copies(st, nl)
    gen = torch.Generator(device=st.device).manual_seed(seed)
    edge = (st.box.prd.double() / torch.tensor(
        nl.params.ncells, dtype=torch.float64, device=st.device)).min()
    jit = (torch.rand(st.x.shape, generator=gen, device=st.device,
                      dtype=torch.float64) - 0.5) * 2 * jitter * edge
    x = torch.where(st.valid_mask[:, None], (st.x.double() + jit).to(dtype),
                    st.x)
    return st.replace(x=x), nl


def rebuild_bytes(st) -> dict:
    """Bytes each kernel must move on a rebuild step: inputs read once,
    outputs written once (the codes read back from L2 not counted)."""
    rows, atoms = st.capacity, st.nlocal
    t = st.x.element_size()
    row = 6 * t + 24 + (t if st.q is not None else 0) + (
        4 if st.molecule is not None else 0)
    return {"sorted_rebin_decide": 4 * rows + 6 * t * atoms,
            "sorted_rebin_bin": 4 * rows + 3 * t * atoms + rows,
            "sorted_rebin_move": row * atoms + rows + row * rows,
            "sorted_rebin_commit": 2 * row * rows + 3 * t * rows}


def kernels_ms(fn, names) -> dict:
    """Device ms a call of each kernel of `names` (by `<name>_kernel`) in
    INNER calls of fn, the median of ROUNDS traces, each after a warm-up
    step of INNER calls with the profiler on; a trace that lost some of
    the calls' records is taken again, up to redesign.TRACE_ATTEMPTS
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def traced() -> dict:
        sel = {n: [] for n in names}

        def keep(prof):
            for e in prof.events():
                if e.device_type != DeviceType.CUDA:
                    continue
                for n in names:
                    if f"{n}_kernel" in e.name:
                        sel[n].append(e.time_range.elapsed_us())

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
    got = {n: [] for n in names}
    for _ in range(ROUNDS):
        for attempt in range(redesign.TRACE_ATTEMPTS):
            sel = traced()
            if all(len(v) == INNER for v in sel.values()):
                for n, v in sel.items():
                    got[n].append(sum(v) / INNER / 1e3)
                break
            say(f"[device_ms] a trace of {names} holds "
                f"{ {n: len(v) for n, v in sel.items()} } records for "
                f"{INNER} calls (attempt {attempt + 1})")
        else:
            raise RuntimeError(f"no complete trace of {names}")
    return {n: statistics.median(v) for n, v in got.items()}


def events_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event ms of fn over reps calls, after one."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timings(st, nl, plain_reps: int = 5) -> dict:
    """Device ms of the four kernels on a rebuild step (`on`) and of the
    gated three on a step that does not rebuild (`off`), the plain
    versions' ms, the bounds."""
    on = torch.ones((), dtype=torch.bool, device=st.device)
    off = torch.zeros((), dtype=torch.bool, device=st.device)
    names = rk.KERNELS[1:]
    # the decision on the cadence (a rebuild sets ago to 0, off it)
    on_cadence = dataclasses.replace(nl, ago=torch.full(
        (), AGO, dtype=torch.int64, device=st.device))
    out = {"on": kernels_ms(lambda: sf.needs_rebuild(st, on_cadence),
                            rk.KERNELS[:1])}
    out["on"].update(kernels_ms(lambda: sf.rebuild_if(st, nl, on), names))
    out["off"] = kernels_ms(lambda: sf.rebuild_if(st, nl, off), names)
    out["plain_ms"] = {
        "needs_rebuild": events_ms(
            lambda: sf.needs_rebuild_reference(st, nl), plain_reps),
        "rebuild_if": events_ms(
            lambda: sf.rebuild_if_reference(st, nl, on), plain_reps)}
    out["bound_ms"] = {k: b / HBM_BYTES_S * 1e3
                       for k, b in rebuild_bytes(st).items()}
    return out


def case(name: str, sim, dtype) -> dict:
    st, nl = segment_state(sim, dtype, SLACK[name])
    p = nl.params
    res = {"grid": name, "dtype": str(dtype).split(".")[-1],
           "ncells": list(p.ncells), "cell_cap": p.cell_cap,
           "rows": st.capacity, "atoms": st.nlocal, **timings(st, nl)}
    del st, nl
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--grids", default="tersoff-1m,eam-1m")
    args = ap.parse_args(argv)
    say(f"[card] {redesign.card()}")
    rk._library()
    say(f"[registers] ptxas, per kernel in build order: "
        f"{redesign.registers(rk.SOURCE)}")
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for grid in args.grids.split(","):
            t0 = time.perf_counter()
            sim = (tersoff_1m(torch.float64) if grid == "tersoff-1m"
                   else eam_1m(torch.float64, tmp))
            say(f"[setup] {grid} {time.perf_counter() - t0:.1f} s")
            for dtype in (torch.float32, torch.float64):
                res = case(grid, sim, dtype)
                say(json.dumps(res))
                results.append(res)
            del sim
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
