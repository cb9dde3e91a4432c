"""PyTorch port: the spans and counters of utils/trace and the deck's
`timer` command, and the benchmark's reduction of a profiled run to spans
(bench_port/spans.py).

CPU, the 864-atom lj melt (6 lattice cells, 3 x 3 x 3 grid cells) for a
few steps. Where a test needs runs free of overflow retries the grid is
re-sized after setup (cell_cap 48), as in test_torch_device_and_retry.py.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bench_port import spans
from lammps_kokkos_port_tpu_torch import presets
from lammps_kokkos_port_tpu_torch.script import LammpsScript, ScriptError
from lammps_kokkos_port_tpu_torch.utils import trace

LOOP_SPANS = {"run", "segment", "segment.launch", "segment.read", "neigh",
              "pair", "output", "output.read"}

DECK = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 6 0 6 0 6
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    every 2 delay 0 check no
fix             1 all nve
thermo          2
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tracing_off_after():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _melt(every=2, check=False, list_mode="auto"):
    """The melt at T 1.44 after setup, on a grid that holds it without
    retries."""
    sim = presets.lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64,
                              every=every, check=check, list_mode=list_mode,
                              device="cpu")
    sim.setup()
    sim.nl = sim._build_list(sim.state, dataclasses.replace(
        sim.nl.params, cell_cap=48))
    sim.presetup_forces()
    return sim


def test_spans_nest_with_parents_self_time_and_a_record_cap(monkeypatch):
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(trace, "time", SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))
    monkeypatch.setattr(trace, "RECORD_CAP", 4)
    trace.enable()
    with trace.span("run"):             # 0 .. 70
        with trace.span("segment"):     # 10 .. 40
            with trace.span("pair"):    # 20 .. 30
                pass
        with trace.span("output"):      # 50 .. 60
            pass
    with trace.span("pair"):            # 80 .. 90, past the cap
        pass
    snap = trace.snapshot()
    assert snap["spans"]["run"] == pytest.approx(
        {"count": 1, "total_s": 70e-9, "self_s": 30e-9})
    assert snap["spans"]["segment"] == pytest.approx(
        {"count": 1, "total_s": 30e-9, "self_s": 20e-9})
    assert snap["spans"]["pair"] == pytest.approx(
        {"count": 2, "total_s": 20e-9, "self_s": 20e-9})
    recs = {r[1]: r for r in snap["records"]}
    assert len(snap["records"]) == 4 and snap["dropped"] == 1
    run_id = recs["run"][0]
    assert recs["run"][4] is None and recs["run"][5] == run_id
    assert recs["segment"][4] == run_id
    assert recs["pair"][4] == recs["segment"][0]
    assert {r[5] for r in snap["records"]} == {run_id}
    assert (recs["pair"][2], recs["pair"][3]) == (20, 30)
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counters": {}, "records": [],
                                "dropped": 0}


def _profiled_run(sim, steps=2):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(steps, thermo_every=2)
    return prof.events()


def test_off_records_nothing_and_opens_no_range():
    sim = _melt()
    trace.count("segment.retries")
    with trace.span("run"):
        pass
    events = _profiled_run(sim)
    assert trace.snapshot() == {"spans": {}, "counters": {}, "records": [],
                                "dropped": 0}
    names = {e.name for e in events}
    assert not names & LOOP_SPANS
    assert not any(e.is_user_annotation for e in events)


def test_on_every_span_is_a_profiler_range():
    sim = _melt()
    trace.enable()
    events = _profiled_run(sim)
    snap = trace.snapshot()
    assert set(snap["spans"]) == LOOP_SPANS
    ranges = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in LOOP_SPANS:
            ranges[e.name] = ranges.get(e.name, 0) + 1
    assert ranges == {k: v["count"] for k, v in snap["spans"].items()}
    # the reduction of that trace: no device operation on the CPU, so the
    # run is one idle gap, charged once to the innermost span open at its
    # middle
    got = spans.reduce(events, LOOP_SPANS)
    run = next(e for e in events if e.name == "run")
    assert got["window_s"] == pytest.approx(
        run.time_range.elapsed_us() * 1e-6)
    assert got["busy_s"] == 0 and got["device_s"] == 0
    assert got["spans"]["run"]["idle_s"] == pytest.approx(got["idle_s"])
    assert sum(v["idle_self_s"] for v in got["spans"].values()) == (
        pytest.approx(got["idle_s"]))


@pytest.mark.parametrize("mode,every,check,list_mode,steps", [
    # the generic step re-bins (wrap + local permutation) on every step
    ("generic", 1, True, "auto", 4),
    # the fused segment re-bins on its cadence only
    ("fused", 2, False, "auto", 6),
    # list mode "cell" re-bins on the host's decision only
    ("cell", 2, False, "cell", 2),
])
def test_rebin_passes_count_attempts(mode, every, check, list_mode, steps):
    sim = _melt(every=every, check=check, list_mode=list_mode)
    builds0 = int(sim.nl.nbuilds)
    trace.enable()
    sim.run(steps, thermo_every=steps)
    snap = trace.snapshot()
    assert "segment.retries" not in snap["counters"]
    passes = snap["counters"]["neigh.rebin_passes"]
    rebuilds = int(sim.nl.nbuilds) - builds0
    if mode == "generic":
        assert passes == steps
        assert 0 <= rebuilds < passes
    else:
        assert passes == rebuilds == steps // every


def test_segment_retries_count_a_forced_overflow():
    sim = _melt()
    real = sim._get_segment_runner()
    fired = []

    def overflowing(state, nl, nsteps):
        state, nl = real(state, nl, nsteps)
        if sim.ntimestep == 2 and not fired:
            fired.append(True)
            nl = dataclasses.replace(nl, overflow=torch.tensor(True))
        return state, nl

    sim._segment_runner = overflowing
    trace.enable()
    sim.run(4, thermo_every=2)
    snap = trace.snapshot()
    assert snap["counters"]["segment.retries"] == 1
    assert snap["spans"]["segment.grow"]["count"] == 1
    assert snap["spans"]["segment"]["count"] == 2
    assert snap["spans"]["segment.launch"]["count"] == 3


def _deck(timer_words, steps=4):
    script = LammpsScript(dtype=torch.float64, device="cpu")
    for line in DECK.strip().splitlines():
        script.one(line)
    if timer_words:
        script.one("timer " + timer_words)
    script._log_lines.clear()
    script.one(f"run {steps}")
    return script


def test_timer_command_prints_the_breakdown():
    trace.enable()   # set-up's spans too
    script = _deck("full")
    lines = script._log_lines
    at = lines.index("MPI task timing breakdown (host times: the device "
                     "runs asynchronously, and Sync holds the waits for "
                     "it):")
    assert lines[at - 2].startswith("Neighbor list builds")
    rows = {ln.split("|")[0].strip(): ln.split("|") for ln in lines[at + 3:]}
    assert list(rows) == ["Pair", "Neigh", "Output", "Sync", "Other"]
    loop = float(next(ln for ln in lines
                      if ln.startswith("Loop time")).split()[3])
    assert sum(float(r[2]) for r in rows.values()) == pytest.approx(
        loop, rel=1e-3)
    assert sum(float(r[-1]) for r in rows.values()) == pytest.approx(
        100.0, abs=0.02)
    assert float(rows["Pair"][2]) > 0 and float(rows["Sync"][2]) > 0
    snap = trace.snapshot()["spans"]
    for name in ("setup.atoms", "setup", "setup.grid", "setup.list"):
        assert snap[name]["count"] >= 1, name
    # create_atoms and create_state: two spans of the lattice set-up
    assert snap["setup.atoms"]["count"] == 2
    # setup's own pair pass, and the neigh build under setup.list
    assert snap["setup"]["total_s"] > snap["setup.list"]["total_s"]


@pytest.mark.parametrize("words", ["off", "loop", "normal", None])
def test_timer_modes(words):
    script = _deck(words, steps=2)
    shown = any(ln.startswith("MPI task timing breakdown")
                for ln in script._log_lines)
    assert shown == (words == "normal")
    assert trace.ON == (words == "normal")


def test_timer_keyword_not_ported_raises():
    script = LammpsScript(dtype=torch.float64, device="cpu")
    with pytest.raises(ScriptError, match="timer keyword sync"):
        script.one("timer sync")


def _ev(name, start, end, device=DeviceType.CPU, cid=0, annot=False):
    return SimpleNamespace(
        name=name, device_type=device, id=cid, is_user_annotation=annot,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_reduce_puts_device_time_and_idle_gaps_under_spans():
    """A hand-built trace (us): run 0-100 > segment 0-60 > pair 10-20 and
    output 60-100 > output.read 90-100. Each device operation is put down
    by the runtime call with its correlation id: the pair kernel (launched
    at 12, in pair, run 15-35), an op launched at 30.5 (in segment, run
    40-45), a row's op (65, run 70-80), one launched after the run (200,
    run 210-211) and one with no runtime call in the trace (run 300-302).
    The range's device-side copy (15-35) is dropped."""
    cuda = DeviceType.CUDA
    events = [
        _ev("run", 0, 100), _ev("segment", 0, 60), _ev("pair", 10, 20),
        _ev("cudaLaunchKernel", 12, 13, cid=1),
        _ev("aten::add", 30, 31, cid=90),
        _ev("cudaLaunchKernel", 30.5, 30.8, cid=2),
        _ev("output", 60, 100), _ev("cudaLaunchKernel", 65, 66, cid=3),
        _ev("output.read", 90, 100),
        _ev("cudaLaunchKernel", 200, 201, cid=4),
        _ev("lj_cell_force_kernel", 15, 35, cuda, cid=1),
        _ev("pair", 15, 35, cuda, annot=True),
        _ev("add_kernel", 40, 45, cuda, cid=2),
        _ev("sum_kernel", 70, 80, cuda, cid=3),
        _ev("mul_kernel", 210, 211, cuda, cid=4),
        _ev("copy_kernel", 300, 302, cuda, cid=5),
    ]
    names = {"run", "segment", "pair", "output", "output.read"}
    got = spans.reduce(events, names, kernels=["lj_cell_force"])
    us = 1e-6
    assert got["window_s"] == pytest.approx(100 * us)
    assert got["busy_s"] == pytest.approx(35 * us)
    assert got["idle_s"] == pytest.approx(65 * us)
    assert got["device_s"] == pytest.approx(38 * us)
    assert got["unattributed_device_s"] == pytest.approx(3 * us)
    s = got["spans"]
    assert s["pair"]["device_self_s"] == pytest.approx(20 * us)
    assert s["segment"]["device_self_s"] == pytest.approx(5 * us)
    assert s["segment"]["device_s"] == pytest.approx(25 * us)
    assert s["output"]["device_s"] == pytest.approx(10 * us)
    assert s["run"]["device_s"] == pytest.approx(35 * us)
    # gaps: 0-15, 35-40 and 45-70 (its middle 57.5 is in segment), 80-100
    # (its middle 90 opens output.read)
    assert s["segment"]["idle_s"] == pytest.approx(45 * us)
    assert s["segment"]["idle_self_s"] == pytest.approx(45 * us)
    assert s["output"]["idle_s"] == pytest.approx(20 * us)
    assert s["output"]["idle_self_s"] == 0
    assert s["output.read"]["idle_self_s"] == pytest.approx(20 * us)
    assert s["run"]["idle_s"] == pytest.approx(65 * us)
    k = got["kernels"]["lj_cell_force"]
    assert k["calls"] == 1 and k["total_s"] == pytest.approx(20 * us)
    assert k["by_span"] == pytest.approx({"pair": 20 * us})
