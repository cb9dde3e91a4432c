"""PyTorch port: where the entry points run, and the mid-run overflow retry.

- The presets and `LammpsScript` run on the card by default; asked for the
  card on a machine without one they raise before building anything.
- An overflow retry in the middle of a run (a cell grew past its capacity
  in a segment that starts after step 0) re-bins the segment's start
  snapshot wrapped into the box, counts the rebuild when it is a new one
  and restarts the cadence from it. The JAX package re-bins the unwrapped
  snapshot (its runner.py:615-646), so these runs are held against the same
  run without a retry, not against JAX. CPU, f64; thermo rows at rel 1e-9.
"""

import dataclasses

import pytest
import torch

from lammps_kokkos_port_tpu_torch import presets
from lammps_kokkos_port_tpu_torch.script import LammpsScript


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_cpu_work(*args, **kwargs):
        raise AssertionError("built atoms on the CPU")

    monkeypatch.setattr(presets, "create_atoms", no_cpu_work)
    for call in (presets.lj_melt_sim, presets.lj_melt_state,
                 presets.lj_melt_pair, LammpsScript,
                 lambda: presets.eam_bulk_cu_sim(potential_path="unused"),
                 lambda: presets.eam_bulk_cu_state(potential_path="unused")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for the CPU, they run there
    assert presets.lj_melt_pair(device="cpu").kernel_key()[0] == "lj"
    assert LammpsScript(device="cpu").device == torch.device("cpu")


def _melt(every, thermo_every, cell_cap=None, inject_at=None):
    """The 864-atom lj melt at T 3, 20 steps, f64 on the CPU. `cell_cap`
    re-sizes the grid after setup (large enough: no retry); `inject_at`
    makes the segment that starts at that step report an overflow once.
    Returns (sim, rows, steps at which the grid grew)."""
    sim = presets.lj_melt_sim(cells=6, t_init=3.0, dtype=torch.float64,
                              every=every, device="cpu")
    sim.setup()
    if cell_cap is not None:
        sim.nl = sim._build_list(sim.state, dataclasses.replace(
            sim.nl.params, cell_cap=cell_cap))
        sim.presetup_forces()
    grew = []
    grow = sim._grow_params

    def recorded_grow(params):
        grew.append(sim.ntimestep)
        return grow(params)

    sim._grow_params = recorded_grow
    if inject_at is not None:
        real = sim._get_segment_runner()
        fired = []

        def overflowing(state, nl, nsteps):
            state, nl = real(state, nl, nsteps)
            if sim.ntimestep == inject_at and not fired:
                fired.append(True)
                nl = dataclasses.replace(nl, overflow=torch.tensor(True))
            return state, nl

        sim._segment_runner = overflowing
    rows = sim.run(20, thermo_every=thermo_every)
    return sim, rows, grew


def _assert_rows_close(rows, ref_rows):
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
    for r, rr in zip(rows, ref_rows):
        for k in ("temp", "epair", "etotal", "press"):
            assert r[k] == pytest.approx(rr[k], rel=1e-9), (r["step"], k)


def test_mid_run_retry_every_1():
    """`neigh_modify every 1`: a retry forced on the segment from step 10.
    The snapshot was built at that very state (ago 0), so the retry only
    resizes that build: nbuilds unchanged, rows as without the retry."""
    sim, rows, grew = _melt(every=1, thermo_every=10, inject_at=10)
    ref, ref_rows, ref_grew = _melt(every=1, thermo_every=10)
    assert 10 in grew and 10 not in ref_grew
    assert sim.nl.params.cell_cap > ref.nl.params.cell_cap
    _assert_rows_close(rows, ref_rows)
    assert sim.nl.nbuilds == ref.nl.nbuilds == 21


def test_mid_run_retry_every_20():
    """bench/in.lj's `every 20 check no` with a row every 10: the segment
    from step 10 overflows by itself. Before the repair the retry re-binned
    the unwrapped snapshot and step 20 ended at etotal -1.04 per atom
    against -2.29. Now the retry is a real rebuild at step 10 (counted;
    the next cadence rebuild moves from step 20 to 30), and the rows agree
    with the same run on a grid sized so that it never retries: the sorted
    layout's forces do not depend on which step re-binned, as long as no
    atom strays a cell between rebuilds."""
    sim, rows, grew = _melt(every=20, thermo_every=10)
    ref, ref_rows, ref_grew = _melt(every=20, thermo_every=10, cell_cap=48)
    assert grew == [10] and ref_grew == []
    assert rows[-1]["etotal"] == pytest.approx(-2.2877903864, abs=1e-9)
    _assert_rows_close(rows, ref_rows)
    # one rebuild each after setup: at step 10 (retry) or step 20 (cadence)
    assert sim.nl.nbuilds == ref.nl.nbuilds == 2
    assert sim.nl.ago == 10 and ref.nl.ago == 0
