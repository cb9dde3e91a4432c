"""One run of one cell: set-up, the measured window, the optional traced
stretch, the comparison with the reference, and the result line.

Set-up (counted in `setup_s`, from process start): build and load the
cell's own CUDA sources (`setup.build_s`); provide the potential file
(`decks.potential`); run the generated deck up to its
last `run` and a `run 0` (atoms, velocities, grid sizing, the first list,
the first force pass and thermo row: `setup.sim_s`); then the deck's `run`
once through `Simulation.run` as the warm-up, which launches every kernel
and operation the window will.

The window repeats `Simulation.run(N, thermo_every)` (the deck's own `run
N` at its thermo cadence) until `--seconds` have passed; it ends with
`torch.cuda.synchronize()`. The rate is atoms x steps over the window's
wall time, with every host read, thermo row, rebuild and retry in it.
With `--trace 1` a stretch of the same runs follows under torch.profiler
and the per-layer readers (`metrics/`) take their numbers from it and from
the end state's counts (`reference.neighbors.work_counts`: pairs, atoms,
and triplets where a kernel's work file names `triplet_ops`).

After the window the memory peak is read, the program's outputs are copied
by atom tag, the program is freed, and the reference decides `correct`
(`check.py`).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import math
import sys
import tempfile
import time
import traceback
from pathlib import Path

from . import check, decks, lookup
from .reference import md
from .reference.models import REF
from .reference.neighbors import work_counts
from .roofline import peaks

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BENCH = REPO / "BENCHMARK.json"
TRACE_TARGET_S = 1.0   # wall of the traced stretch to aim for
TRACE_MAX_RUNS = 20
REBIN = "bench.rebin"
THERMO = "bench.thermo"
SEGMENT = "bench.segment"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class ThermoWatch:
    """Stands in for `sim.thermo` on the instance: the host time spent in
    it, and the state at each thermo row (the snapshot the reference runs
    from). Inside the traced stretch it opens the `bench.thermo` range."""

    def __init__(self, sim):
        self.sim = sim
        self.thermo = sim.thermo
        self.host_s = 0.0
        self.snaps = []      # [(ntimestep, state)], the last two steps
        self.label = None
        sim.thermo = self

    def __call__(self):
        t = time.perf_counter()
        if self.label:
            from torch.profiler import record_function

            with record_function(self.label):
                row = self.thermo()
        else:
            row = self.thermo()
        self.host_s += time.perf_counter() - t
        step = self.sim.ntimestep
        if self.snaps and self.snaps[-1][0] == step:
            self.snaps.pop()
        self.snaps = self.snaps[-1:] + [(step, self.sim.state)]
        return row

    def before(self, step: int):
        """(ntimestep, state) of the last row before `step`."""
        return next(s for s in reversed(self.snaps) if s[0] < step)


def by_tag(state, with_f: bool = False) -> dict:
    """Positions, velocities (and forces) of the real atoms ordered by
    tag, as float64 copies, and the tags."""
    import torch

    valid = state.mask != 0
    tags = state.tag[valid].long()
    order = torch.argsort(tags)
    out = {"tag": tags[order]}
    for k in ("x", "v") + (("f",) if with_f else ()):
        out[k] = getattr(state, k)[valid][order].double()
    return out


def build_sources(modules) -> None:
    """Build (nvcc) and load the libraries of the cell's kernel modules."""
    from lammps_kokkos_port_tpu_torch.ops import cuda_build

    for mod in modules:
        src = getattr(mod, "SOURCE", None)
        if src is not None:
            cuda_build.build(src)
        load = getattr(mod, "_library", None)
        if load is not None:
            load()


def launches(kernels: dict, modules: dict) -> dict:
    """The kernels' launch counters (None where a wrapper has none)."""
    return {k: getattr(getattr(modules[m], k, None), "launches", None)
            for k, m in kernels.items()}


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return e2e, layer


def reader(name: str):
    """`read` of metrics/<name>.py, or of the longest dotted prefix of the
    name that has a file."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        stem = ".".join(parts[:k])
        if (ROOT / "metrics" / f"{stem}.py").exists():
            return lookup.module(ROOT / "metrics", stem,
                                 f"reader of {name!r}").read
    raise FileNotFoundError(f"no reader for metric {name!r} in metrics/")


def end_to_end_value(metric: dict, ctx: dict) -> float:
    name = metric["name"]
    if name == "setup_s":
        return ctx["setup_s"]
    if name.startswith("atom_steps_per_s"):
        w = ctx["window"]
        return ctx["natoms"] * w["steps"] / w["wall_s"]
    raise KeyError(f"the harness takes no end-to-end metric {name!r}")


def run_cell(cell: decks.Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, control: bool = False) -> dict:
    """The result of one run. With `control` the control's numbers, from
    the same snapshot, are added under `info` (for setting the limits)."""
    import torch

    from lammps_kokkos_port_tpu_torch import script as script_mod
    from lammps_kokkos_port_tpu_torch.ops import sortedforce

    config, mix = cell.config, cell.mix
    dtype = getattr(torch, config["dtype"])
    kernels = config["kernels"]
    modules = {m: importlib.import_module(m) for m in kernels.values()}
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t = time.perf_counter()
    if cuda:
        build_sources(modules.values())
    build_s = time.perf_counter() - t

    with tempfile.TemporaryDirectory() as tmp:
        pot = decks.potential(config, cell.config_dir, Path(tmp))
        lines, run_steps = decks.make_deck(config, seed, pot,
                                           cell.config_dir)
        deck_path = Path(tmp) / "deck.in"
        deck_path.write_text("\n".join(lines) + "\n")

        t = time.perf_counter()
        script = script_mod.LammpsScript(
            dtype=dtype, device=device, var_overrides=cell.size_vars,
            list_mode=config["list_mode"])
        with contextlib.redirect_stdout(sys.stderr):
            script.file(str(deck_path))
            script.one("run 0")
        sim = script.sim
        thermo_every = script.thermo_every
        sync()
        sim_s = time.perf_counter() - t

        watch = ThermoWatch(sim)
        sim.run(run_steps, thermo_every)      # warm-up
        sync()
        setup_s = time.perf_counter() - t_start
        log(f"[setup] {setup_s:.3f} s (build {build_s:.3f} s, deck and "
            f"setup {sim_s:.3f} s); {sim.state.nlocal} atoms, grid "
            f"{sim.nl.params.ncells} x cc {sim.nl.params.cell_cap}")

        launches0 = launches(kernels, modules)
        builds0, step0 = int(sim.nl.nbuilds), sim.ntimestep
        watch.host_s = 0.0
        runs, failed, error = 0, 0, None
        rows = None
        t0 = time.perf_counter()
        try:
            while True:
                rows = sim.run(run_steps, thermo_every)
                runs += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            sync()
        except Exception:  # the program failed inside the window
            error = traceback.format_exc()
            failed = 1
        wall = time.perf_counter() - t0
        window = {"wall_s": wall, "steps": sim.ntimestep - step0,
                  "runs": runs, "thermo_s": watch.host_s}
        launches1 = launches(kernels, modules)
        info = {"seed": seed, "deck_seed": decks.deck_seed(seed),
                "window": window, "run_steps": run_steps,
                "launches": {k: (None if launches1[k] is None
                                 else launches1[k] - launches0[k])
                             for k in kernels},
                "nbuilds": int(sim.nl.nbuilds) - builds0,
                "grid": list(sim.nl.params.ncells),
                "cell_cap": sim.nl.params.cell_cap}
        log(f"[window] {runs} runs, {window['steps']} steps in "
            f"{wall:.4f} s; thermo {watch.host_s:.4f} s; launches "
            f"{info['launches']}; rebuilds {info['nbuilds']}")

        traced = None
        if trace and error is None:
            nruns = max(1, min(TRACE_MAX_RUNS, math.ceil(
                TRACE_TARGET_S * runs / wall)))
            targets = [(sortedforce, name, REBIN) for name in (
                "needs_rebuild", "rebuild_if", "rebuild_state")]
            targets.append((sim, "_run_segment_retry", SEGMENT))

            def once():
                nonlocal rows
                rows = sim.run(run_steps, thermo_every)

            from .trace import annotated, traced_runs

            watch.label = THERMO
            try:
                with annotated(targets):
                    traced = traced_runs(once, nruns, [REBIN, THERMO, SEGMENT],
                                         list(kernels))
            except Exception:
                error = traceback.format_exc()
                failed = 1
            watch.label = None
            if traced is not None:
                traced["steps"] = traced["runs"] * run_steps
                log(f"[trace] {traced['runs']} runs: busy "
                    f"{traced['busy_s']:.6f} s of {traced['window_s']:.6f} "
                    f"s, {traced['device_ops']} device ops, ops per run "
                    f"{traced['ops_per_run']}, retakes {traced['retakes']}")

        peak = torch.cuda.max_memory_allocated() if cuda else 0
        natoms = sim.state.nlocal
        health = []
        if error is None:
            end = by_tag(sim.state, with_f=True)
            snap_step, snap_state = watch.before(sim.ntimestep)
            snap = by_tag(snap_state)
            seg_steps = sim.ntimestep - snap_step
            row = rows[-1]
            expect = decks.atoms(config, mix)
            complete = bool(torch.equal(
                end["tag"], torch.arange(1, expect + 1, device=end["tag"]
                                         .device)))
            health += [
                ("atoms", natoms == expect and complete and row["natoms"]
                 == expect, f"{natoms} atoms of {expect}, tags complete "
                 f"{complete}"),
                ("overflow_clear", not bool(sim.nl.overflow),
                 f"overflow {bool(sim.nl.overflow)}"),
                ("rows_finite", all(math.isfinite(v) for v in row.values()
                                    if isinstance(v, float)), "last row"),
            ]
        else:
            health.append(("run", False, error.strip().splitlines()[-1]))
        del sim, script, watch
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        numbers, ctx = {}, None
        if error is None:
            t = time.perf_counter()
            system = check.system_for(config, mix, end["x"].device, pot)
            traj = md.integrate(system, snap["x"], snap["v"], seg_steps,
                                REF)
            numbers = check.gaps(system, end, row, traj[:2])
            info["reference_s"] = time.perf_counter() - t
            if control:
                info["control"] = check.control_numbers(
                    system, snap, seg_steps, traj[:2], config["dtype"])
            info["segment_steps"] = seg_steps
            info["row"] = {k: row[k] for k in ("pe", "press", "temp")}
            log(f"[reference] {seg_steps} steps from step {snap_step} and "
                f"the end state in {info['reference_s']:.3f} s")
            if traced is not None:
                counts = work_counts(end["x"], system.prd,
                                     system.model.cutoff,
                                     peaks.needs_triplets(kernels))
                info["counts"] = counts
                ctx = {"dtype": config["dtype"], "kernels": list(kernels),
                       "build_s": build_s, "sim_s": sim_s, "window": window,
                       "trace": traced, "counts": counts}
        health.append(("no_jax", "jax" not in sys.modules,
                       "jax not imported"))

    correct, shown = check.judge(numbers, check.load_limits(cell.name),
                                 health)
    e2e, layer = cell_metrics(cell.bench, cell.name)
    metrics = {}
    if not trace:
        vctx = {"setup_s": setup_s, "window": window, "natoms": natoms}
        for m in e2e:
            metrics[m["name"]] = {"value": end_to_end_value(m, vctx),
                                  "unit": m["unit"]}
    elif ctx is not None:
        for m in layer:
            value = reader(m["name"])(ctx, m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": runs, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = traced["breakdown"]
        info["trace"] = {k: traced[k] for k in (
            "runs", "steps", "device_ops", "ops_per_run", "retakes",
            "kernels", "ranges")}
    result["info"] = info
    result["checks"] = shown
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = decks.load_cell(BENCH, args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        log(f"{args.workload} needs {cell.entry['chips']} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    for name, c in result["checks"].items():
        log(f"{name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
