"""PyTorch port: the segment runners on the CPU, where they run their steps
in a Python loop and capture no CUDA graph (integrate/graphs).

CPU, float64. The generic runner (integrate/verlet) on the EAM deck (864
Cu atoms on the Sutton-Chen stand-in; `every 1 delay 5 check yes`) and on
the lj melt under `check yes`, against `make_step`'s step in a loop; the
fused runner (integrate/fused) on the lj melt (`every 20 check no`)
against the loop it ran before its steps moved into a carry, written out
here. Each grid is re-sized after setup (cell_cap 40 for EAM, 48 for the
melt, as in test_torch_trace.py), so that no segment overflows. Every comparison is exact: the same operations in
the same order.
The card's path (the graphs) is held to the same loops in
test_torch_segment_graph_cuda.py.
"""

import dataclasses

import pytest
import torch

from lammps_kokkos_port_tpu_torch import presets
from lammps_kokkos_port_tpu_torch.integrate import fused, graphs, verlet
from lammps_kokkos_port_tpu_torch.io.eam_reader import write_sutton_chen_funcfl
from lammps_kokkos_port_tpu_torch.ops import neighbor as nbr
from lammps_kokkos_port_tpu_torch.ops import sortedforce as sf
from lammps_kokkos_port_tpu_torch.utils import trace

ROWS = ("x", "v", "f", "type", "tag", "image", "mask")
LIST = ("ago", "nbuilds", "overflow", "xhold")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once, and each worker's intra-op thread
    pool would otherwise claim every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(kind, tmp_path):
    if kind == "eam":
        pot = write_sutton_chen_funcfl(str(tmp_path / "sc.eam"))
        sim = presets.eam_bulk_cu_sim(cells=6, dtype=torch.float64,
                                      device="cpu", potential_path=pot,
                                      list_mode="sorted")
    else:
        sim = presets.lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64,
                                  device="cpu", every=1 if kind == "lj-check"
                                  else 20, check=kind == "lj-check")
    sim.setup()
    sim.nl = sim._build_list(sim.state, dataclasses.replace(
        sim.nl.params, cell_cap=40 if kind == "eam" else 48))
    sim.presetup_forces()
    return sim


def _assert_equal(a, b, names):
    for k in names:
        assert torch.equal(torch.as_tensor(getattr(a, k)),
                           torch.as_tensor(getattr(b, k))), k


def _step_loop(sim, nsteps):
    """`make_step`'s step in a loop from the segment's copies, finished as
    the runner finishes a segment."""
    step = verlet.make_step(sim.integrator, sim.force_fn)
    st, nl = sf.segment_copies(sim.state, sim.nl)
    for _ in range(nsteps):
        st, nl = step(st, nl)
    st = st.replace(ntimestep=st.ntimestep + nsteps)
    return nbr.poison_on_overflow(st, nl), nl


def _fused_loop(sim, nsteps):
    """The fused segment's loop as it ran before its carry: planar arrays
    re-assigned at each rebuild and force pass."""
    state, nl, integ = sim.state, sim.nl, sim.integrator
    key = sim.pair_style.kernel_key()
    every = max(nl.params.every, 1)

    def row_factors(st):
        gm = st.valid_mask & st.group_mask(integ.groupbit)
        zero = torch.zeros((), dtype=st.dtype)
        return (torch.where(gm, integ.dtf / st.per_atom_mass, zero),
                torch.where(gm, torch.full((), integ.dt, dtype=st.dtype),
                            zero))

    prd = state.box.prd.to(state.dtype)
    st = state
    nl = dataclasses.replace(nl, overflow=nl.overflow.clone())
    xs, vs, fs = sf.planar(state.x), sf.planar(state.v), sf.planar(state.f)
    dtfm, dtv = row_factors(state)
    until_rebuild = every - (nl.ago % every)
    for _ in range(nsteps):
        vs.addcmul_(dtfm, fs)
        xs.addcmul_(dtv, vs)
        until_rebuild -= 1
        if until_rebuild == 0:
            until_rebuild = every
            st = st.replace(x=xs.t(), v=vs.t())
            x, image = st.box.wrap(st.x, st.image)
            st, nl = sf.rebuild_state(st.replace(x=x, image=image), nl)
            xs, vs = sf.planar(st.x), sf.planar(st.v)
            dtfm, dtv = row_factors(st)
        else:
            nl = sf.tick(nl)
        fs = fused.force_planar(key, nl.params, xs, prd)
        vs.addcmul_(dtfm, fs)
    st = st.replace(x=xs.t().contiguous(), v=vs.t().contiguous(),
                    f=fs.t().contiguous(), ntimestep=st.ntimestep + nsteps)
    return nbr.poison_on_overflow(st, nl), nl


@pytest.mark.parametrize("kind, nsteps",
                         [("eam", 30), ("lj-check", 45), ("lj", 45)])
def test_runners_take_the_loop_on_the_cpu(kind, nsteps, tmp_path):
    """Each runner's segment equals the loop, with rebuilds inside, and
    counts no graph step and no capture."""
    sim = _sim(kind, tmp_path)
    state0 = {k: getattr(sim.state, k).clone() for k in ROWS}
    runner = sim._get_segment_runner()
    assert isinstance(sim.nl.ago, int)
    trace.enable()
    trace.reset()
    try:
        got, gnl = runner(sim.state, sim.nl, nsteps)
        counters = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert "segment.graph_steps" not in counters
    assert "segment.graph_captures" not in counters
    assert counters["neigh.rebin_passes"] > 0
    ref, rnl = (_fused_loop if kind == "lj" else _step_loop)(sim, nsteps)
    assert int(rnl.nbuilds) > 2 and not bool(rnl.overflow)
    _assert_equal(got, ref, ROWS)
    _assert_equal(gnl, rnl, LIST)
    assert got.ntimestep == ref.ntimestep == nsteps
    # the state given is left as it was
    for k, a in state0.items():
        assert torch.equal(getattr(sim.state, k), a), k


def test_generic_carry_steps_match_the_loop(tmp_path):
    """The carry the card replays (`verlet._Carry`), stepped eagerly on the
    CPU: loaded from the state, 20 steps, unloaded; equal to `make_step`'s
    loop, and nothing handed out shares the carry's buffers."""
    sim = _sim("eam", tmp_path)
    carry = verlet._Carry(sim.state, sim.nl, sim.integrator, sim.force_fn)
    carry.load(sim.state, sim.nl)
    for _ in range(20):
        carry.step()
    got, gnl = carry.unload(sim.state, sim.nl)
    ref, rnl = _step_loop(sim, 20)
    got = nbr.poison_on_overflow(got, gnl)
    _assert_equal(got, ref, ROWS)
    _assert_equal(gnl, rnl, LIST)
    ptrs = {getattr(carry.state, k).data_ptr() for k in ROWS}
    ptrs |= {getattr(carry.nl, k).data_ptr() for k in LIST}
    assert not ptrs & {getattr(got, k).data_ptr() for k in ROWS}
    assert not ptrs & {getattr(gnl, k).data_ptr() for k in LIST}


def test_layout_key_follows_the_grid(tmp_path):
    """A grown cell_cap or short list is a new key; a later state of the
    same layout is the same key."""
    sim = _sim("eam", tmp_path)
    key = graphs.layout_key(sim.state, sim.nl)
    later, lnl = sim._get_segment_runner()(sim.state, sim.nl, 3)
    assert graphs.layout_key(later, lnl) == key
    grown = dataclasses.replace(sim.nl.params,
                                cell_cap=sim.nl.params.cell_cap + 8)
    st, nl = sf.build(sf.expand_state(sim.state, grown), grown)
    assert graphs.layout_key(st, nl) != key
    wider = dataclasses.replace(sim.nl, short_cap=sim.nl.short_cap + 8)
    assert graphs.layout_key(sim.state, wider) != key


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_set_aside_keeps_counts_apart(on):
    """Counts inside `trace.set_aside` go to its dict, tracing on or off,
    and not to the counters; outside it they count as before."""
    if on:
        trace.enable()
    trace.reset()
    try:
        trace.count("a")
        with trace.set_aside() as got:
            trace.count("a", 2)
            trace.count("b")
        trace.count("a", 3)
        counters = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert got == {"a": 2, "b": 1}
    assert counters == ({"a": 4} if on else {})
