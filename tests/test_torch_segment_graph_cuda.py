"""PyTorch port, the segment runners' CUDA graphs (integrate/graphs) against
their steps run in a Python loop, bit for bit.

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). Run it
on the card with:

    python -m pytest --noconftest -m cuda tests/test_torch_segment_graph_cuda.py

Inputs: the Cu EAM deck on the Sutton-Chen stand-in (4,000 atoms, `every 1
delay 5 check yes`: the generic runner, integrate/verlet) and the lj melt
(4,000 atoms, `every 20 check no`: the fused runner, integrate/fused), f32
and f64, each grid re-sized after setup with 8 more rows a cell so that no
segment overflows where none is planted. The references: `make_step`'s
step in a loop, and the runners' `eager` (their steps in a Python loop,
the CPU's path). Every comparison is exact: a replay launches the eager
step's kernels in its order on the same inputs, and the force kernels sum
in a fixed order.
"""

import dataclasses

import pytest
import torch

from lammps_kokkos_port_tpu_torch import presets
from lammps_kokkos_port_tpu_torch.integrate import verlet
from lammps_kokkos_port_tpu_torch.io.eam_reader import write_sutton_chen_funcfl
from lammps_kokkos_port_tpu_torch.ops import eam_kernels as ek
from lammps_kokkos_port_tpu_torch.ops import neighbor as nbr
from lammps_kokkos_port_tpu_torch.ops import pair_kernels as pk
from lammps_kokkos_port_tpu_torch.ops import rebin_kernels as rk
from lammps_kokkos_port_tpu_torch.ops import sortedforce as sf
from lammps_kokkos_port_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
ROWS = ("x", "v", "f", "type", "tag", "image", "mask")
LIST = ("ago", "nbuilds", "overflow", "xhold")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _roomy(sim):
    sim.setup()
    sim.nl = sim._build_list(sim.state, dataclasses.replace(
        sim.nl.params, cell_cap=sim.nl.params.cell_cap + 8))
    sim.presetup_forces()
    return sim


def _eam(dtype, device, tmp_path):
    pot = write_sutton_chen_funcfl(str(tmp_path / "sc.eam"))
    return _roomy(presets.eam_bulk_cu_sim(cells=10, dtype=dtype,
                                          device=device, potential_path=pot,
                                          list_mode="sorted"))


def _melt(dtype, device):
    return _roomy(presets.lj_melt_sim(cells=10, t_init=1.44, dtype=dtype,
                                      device=device))


def _assert_equal(a, b, names):
    for k in names:
        assert torch.equal(torch.as_tensor(getattr(a, k)),
                           torch.as_tensor(getattr(b, k))), k


def _counters(fn):
    """fn()'s utils/trace counters."""
    trace.enable()
    trace.reset()
    try:
        fn()
        return trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()


def _launches(*wrappers):
    return [w.launches for w in wrappers]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_generic_graph_matches_the_step_loop(cuda, tmp_path, dtype):
    """Two graphed segments (25 and 35 steps, rebuilds inside) equal
    `make_step`'s step in a loop over 60; the state handed out of the first
    segment is unchanged after the second runs; every step is a graph step
    (one capture), and each kernel counts one launch a step."""
    sim = _eam(dtype, cuda, tmp_path)
    runner = sim._get_segment_runner()
    wrappers = (ek.eam_cell_rho, ek.eam_cell_force, rk.sorted_rebin_decide,
                rk.sorted_rebin_bin, rk.sorted_rebin_move,
                rk.sorted_rebin_commit)
    n0 = _launches(*wrappers)
    out = {}

    def two_segments():
        out["first"] = runner(sim.state, sim.nl, 25)
        out["kept"] = [{k: getattr(a, k).clone() for k in names}
                       for a, names in zip(out["first"], (ROWS, LIST))]
        out["second"] = runner(*out["first"], 35)

    counters = _counters(two_segments)
    torch.cuda.synchronize()
    assert counters["segment.graph_steps"] == 60
    assert counters["segment.graph_captures"] == 1
    assert counters["neigh.rebin_passes"] == 60
    assert [n - m for n, m in zip(_launches(*wrappers), n0)] == [60] * 6
    for a, kept in zip(out["first"], out["kept"]):
        for k, t in kept.items():
            assert torch.equal(getattr(a, k), t), k

    step = verlet.make_step(sim.integrator, sim.force_fn)
    st, nl = sf.segment_copies(sim.state, sim.nl)
    for _ in range(60):
        st, nl = step(st, nl)
    got, gnl = out["second"]
    assert int(nl.nbuilds) > 3 and not bool(nl.overflow)
    _assert_equal(got, st, ROWS)
    _assert_equal(gnl, nl, LIST)
    assert got.ntimestep == sim.state.ntimestep + 60


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_fused_graph_matches_the_loop(cuda, dtype):
    """Two graphed segments of 50 steps (the plain step's graph and the
    rebuild step's, picked by the cadence) equal the eager loop's 100
    steps across five rebuilds; two captures, each kernel counted once a
    step (the re-bin's once a rebuild)."""
    sim = _melt(dtype, cuda)
    runner = sim._get_segment_runner()
    wrappers = (pk.lj_cell_force, rk.sorted_rebin_bin, rk.sorted_rebin_move)
    n0 = _launches(*wrappers)
    out = {}

    def two_segments():
        first = runner(sim.state, sim.nl, 50)
        out["got"] = runner(*first, 50)

    counters = _counters(two_segments)
    torch.cuda.synchronize()
    assert counters["segment.graph_steps"] == 100
    assert counters["segment.graph_captures"] == 2
    assert counters["neigh.rebin_passes"] == 5
    assert [n - m for n, m in zip(_launches(*wrappers), n0)] == [100, 5, 5]
    ref, rnl = runner.eager(sim.state, sim.nl, 100)
    got, gnl = out["got"]
    assert gnl.nbuilds == rnl.nbuilds == sim.nl.nbuilds + 5
    assert not bool(rnl.overflow)
    _assert_equal(got, ref, ROWS)
    _assert_equal(gnl, rnl, LIST)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_grown_cell_cap_captures_again(cuda, tmp_path, dtype):
    """`Simulation.run(60, thermo_every=20)` with an overflow planted on its
    first segment: the retry grows cell_cap, which is a new layout, so the
    graphed run captures that layout's graphs too. Its rows and end state
    equal the eager run's under the same planted overflow."""
    sims = [_eam(dtype, cuda, tmp_path) for _ in range(2)]
    cc0 = sims[0].nl.params.cell_cap
    for i, sim in enumerate(sims):
        real = sim._get_segment_runner()
        real = real if i == 0 else real.eager
        planted = []

        def overflowing(state, nl, nsteps, real=real, planted=planted):
            state, nl = real(state, nl, nsteps)
            if not planted:
                planted.append(nsteps)
                nl = dataclasses.replace(nl, overflow=torch.ones(
                    (), dtype=torch.bool, device=cuda))
                state = nbr.poison_on_overflow(state, nl)
            return state, nl

        sim._segment_runner = overflowing
    rows = {}
    counters = _counters(lambda: rows.update(graphed=sims[0].run(60, 20)))
    rows["eager"] = sims[1].run(60, 20)
    assert counters["segment.retries"] == 1
    assert counters["segment.graph_captures"] == 2  # one a layout
    assert counters["segment.graph_steps"] == 80
    assert sims[0].nl.params.cell_cap > cc0
    assert sims[0].nl.params == sims[1].nl.params
    assert rows["graphed"] == rows["eager"]
    _assert_equal(sims[0].state, sims[1].state, ROWS)
    assert sims[0].nl.nbuilds == sims[1].nl.nbuilds
