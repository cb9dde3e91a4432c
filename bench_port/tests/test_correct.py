"""The comparison that decides `correct`, driven on the CPU at a size a
test run holds (the lj-melt deck at -var x 0.4: 2,048 atoms; the port runs
its plain PyTorch twins there): a sound run is correct and within the
limits of `limits/lj-melt.32k.json`; the control fails them; and a run
with the timed path broken underneath comes out not correct, once for
each fault a one-chip MD cell can have: a step that returns its state
unchanged, half of the atoms' forces left out, one atom's force altered
where the kernel produces it. (No cell exchanges data between chips.)

    python -m pytest bench_port/tests -q
"""

import time

import pytest
import torch

from bench_port import check, decks, harness
from lammps_kokkos_port_tpu_torch import runner
from lammps_kokkos_port_tpu_torch.integrate import fused

CELL = "lj-melt.32k"
TINY = {"name": "tiny", "vars": {"x": 0.4, "y": 0.4, "z": 0.4}}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(seed=20231, control=False):
    cell = decks.load_cell(harness.BENCH, CELL)
    cell.mix = TINY
    return harness.run_cell(cell, seed, 0.2, False, "cpu",
                            time.perf_counter(), control=control)


def test_sound_run_is_correct_and_the_control_is_not():
    res = run(control=True)
    assert res["correct"], res["checks"]
    limits = check.load_limits(CELL)
    ctrl = res["info"]["control"]
    assert any(ctrl[k] > limits[k] for k in check.NUMBERS), ctrl


def _wrap_kernel(monkeypatch, change, after=0):
    """The step loop's kernel, broken from its `after`-th call on."""
    kernel = fused.lj_cell_force
    calls = [0]

    def broken(key, ncells, gx, gy, gz, prd):
        out = kernel(key, ncells, gx, gy, gz, prd)
        calls[0] += 1
        if calls[0] > after:
            change(out, gx)
        return out

    monkeypatch.setattr(fused, "lj_cell_force", broken)


def test_state_left_unchanged(monkeypatch):
    def frozen(self):
        return lambda state, nl, n: (state.replace(
            ntimestep=state.ntimestep + n), nl)

    monkeypatch.setattr(runner.Simulation, "_get_segment_runner", frozen)
    res = run()
    assert not res["correct"]
    assert res["checks"]["position_rms"]["value"] > res["checks"][
        "position_rms"]["limit"]


def test_half_the_forces_left_out(monkeypatch):
    # over the last 5 steps of the window's one run (100 warm-up steps, 100
    # in the window): from the start, the atoms without forces overlap and
    # the run ends in the capacity retry's error, after minutes on the CPU
    def halve(out, gx):
        out[:, out.shape[1] // 2:] = 0.0

    _wrap_kernel(monkeypatch, halve, after=195)
    res = run()
    assert not res["correct"]
    assert res["checks"]["force_gap"]["value"] > res["checks"]["force_gap"][
        "limit"]


def test_one_force_altered(monkeypatch):
    def alter(out, gx):
        row = int(torch.nonzero(gx.reshape(-1) < 1e7)[0])
        out[0].reshape(-1)[row] += 1.0

    _wrap_kernel(monkeypatch, alter)
    res = run()
    assert not res["correct"]
    assert res["checks"]["force_gap"]["value"] > res["checks"]["force_gap"][
        "limit"]
