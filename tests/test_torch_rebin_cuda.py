"""PyTorch port, the sorted layout's re-bin kernels against their plain
versions, bit for bit.

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). Run it
on the card with:

    python -m pytest --noconftest -m cuda tests/test_torch_rebin_cuda.py

`sortedforce.needs_rebuild`, `rebuild_if` and `rebuild_state` launch the
kernels of ops/rebin_kernels (csrc/sorted_rebin.cu) on CUDA tensors; the
plain versions (`*_reference`) run on the same CUDA tensors. Inputs: the
sorted states of the lj melt (4,000 atoms), the Cu EAM deck on the
Sutton-Chen stand-in (4,000 atoms) and bench/POTENTIALS/in.tersoff (32,000
Si atoms), f32 and f64, re-sorted with room in every cell and moved by a
seeded jitter of most of a cell (atoms cross cells and the box's faces).
Every comparison is exact: the kernels wrap and bin with the plain
version's rounded operations and write its slot order.
"""

import dataclasses
from pathlib import Path

import pytest
import torch

from lammps_kokkos_port_tpu_torch import presets
from lammps_kokkos_port_tpu_torch.integrate.verlet import make_step_segment
from lammps_kokkos_port_tpu_torch.io.eam_reader import write_sutton_chen_funcfl
from lammps_kokkos_port_tpu_torch.ops import rebin_kernels as rk
from lammps_kokkos_port_tpu_torch.ops import sortedforce as sf
from lammps_kokkos_port_tpu_torch.script import LammpsScript

pytestmark = pytest.mark.cuda

CONFIGS = Path(__file__).resolve().parents[1] / "bench_port" / "configs"
DTYPES = [torch.float32, torch.float64]
KINDS = ["lj", "eam", "tersoff"]
FIELDS = ("x", "v", "f", "type", "tag", "image", "mask")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sim(kind, dtype, device, tmp_path):
    if kind == "lj":
        sim = presets.lj_melt_sim(cells=10, t_init=1.44, dtype=dtype,
                                  every=1, delay=0, check=True,
                                  device=device)
    elif kind == "eam":
        pot = write_sutton_chen_funcfl(str(tmp_path / "sc.eam"))
        sim = presets.eam_bulk_cu_sim(cells=10, dtype=dtype, device=device,
                                      potential_path=pot,
                                      list_mode="sorted")
    else:
        text = (CONFIGS / "tersoff-si.in").read_text().replace(
            "Si.tersoff", str(CONFIGS / "Si.tersoff"))
        script = LammpsScript(dtype=dtype, device=device,
                              list_mode="sorted")
        for line in text.splitlines():
            if not line.startswith("run"):
                script.one(line)
        script.one("run 0")
        return script.sim
    sim.setup()
    return sim


def _roomy(sim, slack=16):
    """The sim's state re-sorted with `slack` more rows a cell, as the
    segment holds it (its own copies, device counters)."""
    p = dataclasses.replace(sim.nl.params,
                            cell_cap=sim.nl.params.cell_cap + slack)
    st, nl = sf.build(sf.expand_state(sim.state, p), p,
                      sim.nl.short_cap)
    nl = dataclasses.replace(nl, ago=3, nbuilds=2, xhold=st.x.clone())
    return sf.segment_copies(st, nl)


def _jittered(st, nl, frac=0.9, seed=5):
    gen = torch.Generator(device=st.device).manual_seed(seed)
    edge = (st.box.prd.double() / torch.tensor(
        nl.params.ncells, dtype=torch.float64, device=st.device)).min()
    jit = (torch.rand(st.x.shape, generator=gen, device=st.device,
                      dtype=torch.float64) - 0.5) * frac * edge
    return st.replace(x=torch.where(st.valid_mask[:, None],
                                    (st.x.double() + jit).to(st.dtype),
                                    st.x))


def _copy(st, nl):
    """Deep copies, so that a kernel's in-place writes leave these be."""
    st2 = st.replace(**{k: getattr(st, k).clone() for k in FIELDS})
    return st2, dataclasses.replace(
        nl, ago=nl.ago.clone(), nbuilds=nl.nbuilds.clone(),
        overflow=nl.overflow.clone(), xhold=nl.xhold.clone())


def _assert_lists_equal(a, b):
    for k in ("ago", "nbuilds", "overflow", "xhold"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def _assert_states_equal(a, b, fields=FIELDS):
    for k in fields:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
def test_step_without_rebuild_leaves_state(cuda, tmp_path, kind, dtype):
    sim = _sim(kind, dtype, cuda, tmp_path)
    st, nl = _roomy(sim)
    st = _jittered(st, nl)
    before, nl0 = _copy(st, nl)
    n = (rk.sorted_rebin_bin.launches, rk.sorted_rebin_move.launches,
         rk.sorted_rebin_commit.launches)
    out, cl = sf.rebuild_if(st, nl, torch.zeros((), dtype=torch.bool,
                                                device=cuda))
    assert out is st and cl is nl  # in place
    _assert_states_equal(out, before)
    assert torch.equal(cl.xhold, nl0.xhold)
    assert (int(cl.ago), int(cl.nbuilds), bool(cl.overflow)) == (4, 2,
                                                                 False)
    assert (rk.sorted_rebin_bin.launches, rk.sorted_rebin_move.launches,
            rk.sorted_rebin_commit.launches) == tuple(k + 1 for k in n)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
def test_rebuild_step_matches_plain(cuda, tmp_path, kind, dtype):
    """Atoms crossing cells and the box's faces: the permutation, the
    wrapped positions and images and every moved array bit-equal."""
    sim = _sim(kind, dtype, cuda, tmp_path)
    st, nl = _roomy(sim)
    st = _jittered(st, nl)
    st_ref, nl_ref = _copy(st, nl)
    flag = torch.ones((), dtype=torch.bool, device=cuda)
    ref, rcl = sf.rebuild_if_reference(st_ref, nl_ref, flag)
    out, cl = sf.rebuild_if(st, nl, flag)
    assert not bool(rcl.overflow)
    _assert_states_equal(out, ref)
    _assert_lists_equal(cl, rcl)
    assert not torch.equal(ref.tag, st_ref.tag)      # rows moved
    assert not torch.equal(ref.image, st_ref.image)  # across faces
    # the pad rows: the diagonal sentinels and zeros
    pads = ref.mask == 0
    want = sf._pad_x(ref.capacity, dtype, cuda)
    assert torch.equal(out.x[pads], want[pads][:, None].expand(-1, 3))
    assert bool(pads.any()) and not bool(out.v[pads].any())
    assert not bool(out.tag[pads].any()) and not bool(out.image[pads].any())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
def test_decision_matches_plain(cuda, tmp_path, kind, dtype):
    """The flag on and off the cadence, below and past half the skin, with
    `check` and without."""
    sim = _sim(kind, dtype, cuda, tmp_path)
    st, nl = _roomy(sim)
    skin = nl.params.skin
    for check in (True, False):
        for every, delay in ((1, 0), (1, 5), (3, 0), (2, 4)):
            p = dataclasses.replace(nl.params, check=check, every=every,
                                    delay=delay)
            for step in (0.3, 0.6):  # displacement / skin of one atom
                row = int(torch.nonzero(st.mask)[7])
                x = st.x.clone()
                x[row, 1] += step * skin
                moved = st.replace(x=x)
                for ago in range(7):
                    cl = dataclasses.replace(
                        nl, params=p, ago=torch.tensor(ago, device=cuda))
                    got = sf.needs_rebuild(moved, cl)
                    want = sf.needs_rebuild_reference(moved, cl)
                    assert bool(got) == bool(want), (check, every, delay,
                                                     step, ago)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_jump_and_full_cell_overflow(cuda, tmp_path, dtype):
    """A move of two cells, and a cell over cell_cap, raise the overflow
    flag on a rebuild step, as in the plain version; not on other steps."""
    sim = _sim("lj", dtype, cuda, tmp_path)
    st, nl = _roomy(sim)
    on = torch.ones((), dtype=torch.bool, device=cuda)
    row = int(torch.nonzero(st.mask)[0])
    edge = float(st.box.prd[0]) / nl.params.ncells[0]
    assert nl.params.ncells[0] >= 5
    x = st.x.clone()
    x[row, 0] += 2.0 * edge
    jumped = st.replace(x=x)
    for flag, want in ((on, True), (~on, False)):
        s, c = _copy(jumped, nl)
        assert bool(sf.rebuild_if(s, c, flag)[1].overflow) == want
        assert bool(sf.rebuild_if_reference(jumped, nl, flag)[1]
                    .overflow) == want
    # the rows of three neighbours of cell 0 moved to its centre: more
    # than it holds
    cc, (nx, ny, nz) = nl.params.cell_cap, nl.params.ncells
    centre = st.box.lo + st.box.prd / torch.tensor(
        [nx, ny, nz], device=cuda, dtype=dtype) * 0.5
    cell = torch.arange(st.capacity, device=cuda) // cc
    near = torch.isin(cell, torch.tensor([1, nz, ny * nz], device=cuda)) & (
        st.mask != 0)
    assert int(near.sum()) > cc
    x = st.x.clone()
    x[near] = centre
    crowded = st.replace(x=x)
    s, c = _copy(crowded, nl)
    assert bool(sf.rebuild_if(s, c, on)[1].overflow)
    assert bool(sf.rebuild_if_reference(crowded, nl, on)[1].overflow)


def _plain(monkeypatch):
    """Route sortedforce's re-bin to the plain versions."""
    monkeypatch.setattr(sf, "needs_rebuild", sf.needs_rebuild_reference)
    monkeypatch.setattr(sf, "rebuild_if", sf.rebuild_if_reference)
    monkeypatch.setattr(sf, "rebuild_state", sf.rebuild_state_reference)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["lj", "eam"])
def test_generic_segment_matches_plain(cuda, tmp_path, kind, dtype,
                                       monkeypatch):
    """100 steps of the generic step (`check yes`) with rebuilds in them:
    the same trajectory, bit for bit (the lj and EAM force kernels sum in a
    fixed order)."""
    sims = [_sim(kind, dtype, cuda, tmp_path) for _ in range(2)]
    n0 = rk.sorted_rebin_move.launches
    runner = make_step_segment(sims[0].integrator, sims[0].force_fn)
    out, cl = runner(sims[0].state, sims[0].nl, 100)
    assert rk.sorted_rebin_move.launches == n0 + 100
    with monkeypatch.context() as m:
        _plain(m)
        # the steps in a loop: the plain versions read the host, which a
        # CUDA graph's capture cannot
        runner = make_step_segment(sims[1].integrator, sims[1].force_fn)
        ref, rcl = runner.eager(sims[1].state, sims[1].nl, 100)
    assert int(rcl.nbuilds) > 2
    _assert_states_equal(out, ref)
    _assert_lists_equal(cl, rcl)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_fused_segment_matches_plain(cuda, dtype, monkeypatch):
    """bench/in.lj's fused segment (`every 20 check no`): rebuild_state
    through bin and move with no flag; 100 steps equal the plain
    version's."""
    sims = [presets.lj_melt_sim(cells=10, t_init=1.44, dtype=dtype,
                                device=cuda) for _ in range(2)]
    for sim in sims:
        sim.setup()
    n0 = rk.sorted_rebin_bin.launches
    sims[0].run(100, thermo_every=50)
    assert rk.sorted_rebin_bin.launches >= n0 + 5
    with monkeypatch.context() as m:
        _plain(m)
        sims[1]._segment_runner = sims[1]._get_segment_runner().eager
        sims[1].run(100, thermo_every=50)
    _assert_states_equal(sims[0].state, sims[1].state)
    assert sims[0].nl.nbuilds == sims[1].nl.nbuilds == 6


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_grow_retry_replays_from_an_intact_snapshot(cuda, tmp_path, dtype,
                                                    monkeypatch):
    """The first segment (20 steps of the EAM deck, rebuilding in place on
    the card) is made to report an overflow: the retry grows the grid and
    replays the segment from the snapshot, which the kernels' in-place
    writes must have left intact. The run equals the plain version's,
    whose arrays are all fresh, under the same planted overflow."""
    sims = [_sim("eam", dtype, cuda, tmp_path) for _ in range(2)]
    grew, fired = [], {}
    for i, sim in enumerate(sims):
        real = sim._get_segment_runner()
        real = real if i == 0 else real.eager  # the plain side's loop
        grow = sim._grow_params

        def overflowing(state, nl, nsteps, real=real, i=i):
            state, nl = real(state, nl, nsteps)
            if i not in fired:
                fired[i] = int(nl.nbuilds)  # rebuilds inside the segment
                nl = dataclasses.replace(nl, overflow=torch.ones(
                    (), dtype=torch.bool, device=cuda))
            return state, nl

        def recorded(params, grow=grow, sim=sim):
            grew.append(sim.ntimestep)
            return grow(params)

        sim._segment_runner = overflowing
        sim._grow_params = recorded
    snap = {k: getattr(sims[0].state, k).clone() for k in FIELDS}
    state0 = sims[0].state
    rows = sims[0].run(40, thermo_every=20)
    for k, a in snap.items():
        assert torch.equal(getattr(state0, k), a), k
    with monkeypatch.context() as m:
        _plain(m)
        ref_rows = sims[1].run(40, thermo_every=20)
    # each run's first segment rebuilt, then was replayed
    assert grew == [0, 0] and fired[0] == fired[1] > 1
    assert rows == ref_rows
    _assert_states_equal(sims[0].state, sims[1].state)
    assert sims[0].nl.nbuilds == sims[1].nl.nbuilds


@pytest.mark.parametrize("kind", KINDS)
def test_step_reads_no_host(cuda, tmp_path, kind):
    """needs_rebuild + rebuild_if make no host synchronisation."""
    sim = _sim(kind, torch.float64, cuda, tmp_path)
    st, nl = _roomy(sim)
    st = _jittered(st, nl)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            flag = sf.needs_rebuild(st, nl)
            st, nl = sf.rebuild_if(st, nl, flag)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(nl.ago) + int(nl.nbuilds) >= 3
