"""PyTorch port, Tersoff Si (bench/POTENTIALS/in.tersoff) on the CPU.

The port's sorted path (the plain twins of ops/tersoff_kernels) against
the benchmark's plain reference (bench_port/reference/pair_tersoff.py,
loaded from its file; autograd forces) and the JAX package's
`PairTersoff` (jax.grad of one energy over its neighbour matrix), on 4 x 4
x 4 diamond cells (512 atoms) of the repository's Si.tersoff in float64,
positions displaced by a seeded 0.05 A rms.

Tolerances: the three compute the same sums in other orders and by other
derivatives (the port's analytic chain rule, autograd in the reference and
in JAX): forces within 1e-10 of the largest |force| (measured 3e-15
against the reference); pe and the six virial terms rtol 1e-10, with atol
1e-10 of the largest virial term (an off-diagonal term can be near 0). The
JAX package clamps beta zeta at 30 and the exponent at +-69, LAMMPS's
branches switch at other points: no state of this test comes near either.
The perfect crystal's step-0 energy per atom is the published log's within
1e-7 (log.9Oct20.tersoff.1: -148173.19 eV for 32,000 atoms, printed to 8
digits). The reference's forces are central differences of its energy
with h = 1e-5 A, whose truncation error is about 1e-8 of a force of 1 eV/A:
rtol 1e-6, atol 1e-7. The deck's 20 steps through `LammpsScript` against
the reference's velocity Verlet: positions within 1e-9 A and velocities
within 1e-8 of the rms speed (forces agree to 1e-15; 20 steps of 1 fs
grow that by a few orders at most).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_port.reference import md
from bench_port.reference.models import REF
from bench_port.reference.neighbors import half_pairs
from lammps_kokkos_port_tpu.presets import tersoff_si_sim
from lammps_kokkos_port_tpu_torch.models.pair_tersoff import (
    make_tersoff,
    read_tersoff_file,
)
from lammps_kokkos_port_tpu_torch.ops import sortedforce, tersoff_kernels
from lammps_kokkos_port_tpu_torch.script import LammpsScript
from lammps_kokkos_port_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "bench_port" / "configs"
POT = str(CONFIGS / "Si.tersoff")
E0_PER_ATOM = -148173.19 / 32000  # log.9Oct20.tersoff.1, step 0
CELLS = 4


def _reference_module():
    path = REPO / "bench_port" / "reference" / "pair_tersoff.py"
    spec = importlib.util.spec_from_file_location("ref_pair_tersoff", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_TERSOFF = _reference_module()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deck_lines(cells=CELLS, run=None):
    """The published deck with the region cut to `cells` diamond cells a
    side and the repository's potential file; without its `run` line
    unless `run` is given."""
    text = (CONFIGS / "tersoff-si.in").read_text().replace("Si.tersoff", POT)
    for v in ("20*$x", "20*$y", "10*$z"):
        text = text.replace(v, str(cells))
    lines = [ln for ln in text.splitlines() if not ln.startswith("run")]
    return lines + ([f"run {run}"] if run is not None else [])


def port_sim(cells=CELLS):
    script = LammpsScript(dtype=torch.float64, device="cpu",
                          list_mode="sorted")
    for line in deck_lines(cells):
        script.one(line)
    return script, script._build_simulation()


def by_tag(state, a):
    valid = state.valid_mask
    order = torch.argsort(state.tag[valid].long())
    return a[valid][order]


def displaced(sim, seed=0, scale=0.05):
    """The port's state with each atom moved by a seeded normal of `scale`
    A a component (by tag), and the displacement by tag."""
    st = sim.state
    n = st.nlocal
    disp = torch.tensor(np.random.default_rng(seed).normal(
        scale=scale, size=(n, 3)))
    x = st.x.clone()
    rows = torch.nonzero(st.valid_mask).flatten()
    x[rows] += disp[st.tag[rows].long() - 1]
    return st.replace(x=x), disp


def reference_of(x_by_tag, prd):
    model = REF_TERSOFF.Tersoff(REF_TERSOFF.read(POT))
    return model, model.evaluate(x_by_tag, prd,
                                 half_pairs(x_by_tag, prd, 4.2), REF, True)


@pytest.fixture(scope="module")
def sim():
    return port_sim()[1]


def test_reader_and_style():
    e = read_tersoff_file(POT)[("Si", "Si", "Si")]
    assert (e["m"], e["n"], e["biga"], e["bigr"], e["bigd"]) == (
        3.0, 22.956, 3264.7, 3.0, 0.2)
    style = make_tersoff(1, POT, ["Si"])
    assert set(style.force_paths.modes) == {"sorted"}
    assert style.max_cutoff() == 3.2
    with pytest.raises(NotImplementedError, match="single element"):
        make_tersoff(2, POT, ["Si", "Si"])
    ref = REF_TERSOFF.read(POT)
    assert tuple(ref[k] for k in REF_TERSOFF.FIELDS) == style.kernel_params()


@pytest.mark.parametrize("words,match", [
    ("pair_style tersoff/mod", "tersoff/mod"),
    ("pair_style tersoff/zbl", "tersoff/zbl"),
    ("pair_style tersoff shift 0.05", "shift")])
def test_unported_variants_raise(words, match):
    with pytest.raises(NotImplementedError, match=match):
        LammpsScript(dtype=torch.float64, device="cpu").one(words)


def test_step0_energy_matches_the_log(sim):
    row = sim.thermo()
    assert row["natoms"] == 8 * CELLS ** 3
    assert row["epair"] / row["natoms"] == pytest.approx(E0_PER_ATOM,
                                                         rel=1e-7)
    st = sim.state
    x = by_tag(st, st.x)
    _, res = reference_of(x, st.box.prd.double())
    assert res.pe / x.shape[0] == pytest.approx(E0_PER_ATOM, rel=1e-7)


def test_port_matches_reference_and_jax(sim):
    st, disp = displaced(sim)
    f, pe, _, vir = sim.force_fn(st, sim.nl, True, True)
    f = by_tag(st, f)
    x = by_tag(st, st.x)
    _, res = reference_of(x, st.box.prd.double())
    scale = float(res.f.abs().max())
    np.testing.assert_allclose(f.numpy(), res.f.numpy(), rtol=0,
                               atol=1e-10 * scale)
    assert float(pe) == pytest.approx(res.pe, rel=1e-10)
    vscale = max(abs(v) for v in res.virial)
    np.testing.assert_allclose(vir.numpy(), res.virial, rtol=1e-10,
                               atol=1e-10 * vscale)

    jsim = tersoff_si_sim(cells=(CELLS,) * 3, dtype=jnp.float64,
                          potential_path=POT)
    jsim.setup()
    jst = jsim.state
    tags = np.asarray(jst.tag)
    jvalid = np.asarray(jst.mask) != 0
    jx = np.asarray(jst.x).copy()
    jx[jvalid] += disp.numpy()[tags[jvalid] - 1]
    jf, je, jvir = jsim.pair_style.compute(jst.replace(x=jnp.asarray(jx)),
                                           jsim.nl, True, True)
    order = np.argsort(tags[jvalid])
    np.testing.assert_allclose(f.numpy(), np.asarray(jf)[jvalid][order],
                               rtol=0, atol=1e-10 * scale)
    assert float(pe) == pytest.approx(float(je), rel=1e-10)
    np.testing.assert_allclose(vir.numpy(), np.asarray(jvir), rtol=1e-10,
                               atol=1e-10 * vscale)


def test_reference_forces_are_its_energy_gradient(sim):
    st, _ = displaced(sim, seed=1)
    x = by_tag(st, st.x)
    prd = st.box.prd.double()
    model, res = reference_of(x, prd)
    h = 1e-5
    for atom in (0, 111, 400):
        for d in range(3):
            e = []
            for s in (h, -h):
                xs = x.clone()
                xs[atom, d] += s
                e.append(model.evaluate(xs, prd, half_pairs(xs, prd, 4.2),
                                        REF, True).pe)
            fd = -(e[0] - e[1]) / (2 * h)
            assert float(res.f[atom, d]) == pytest.approx(fd, rel=1e-6,
                                                          abs=1e-7)


def test_short_list_twin_by_brute_force(sim):
    st, _ = displaced(sim, seed=2, scale=0.1)
    p = sim.nl.params
    prd = st.box.prd.to(st.dtype)
    short, nshort, counts = tersoff_kernels.tersoff_short_reference(
        3.2 ** 2, p.ncells, st.x, st.mask, prd, 16)
    valid = st.valid_mask
    d = st.x[:, None, :] - st.x[None, :, :]
    d = d - prd * torch.round(d / prd)
    near = ((d * d).sum(-1) < 3.2 ** 2) & valid[:, None] & valid[None, :]
    near.fill_diagonal_(False)
    assert torch.equal(counts, near.sum(1))
    for r in torch.nonzero(valid).flatten()[::37].tolist():
        got = short[r, :int(nshort[r])].long().tolist()
        assert sorted(got) == torch.nonzero(near[r]).flatten().tolist()
    assert int(nshort[~valid].abs().sum()) == 0


def test_force_twin_reads_no_slot_past_the_count(sim):
    """The kernel leaves a row's slots past its count unwritten: the force
    twin, fed such a list (here out-of-range row ids), gives the forces and
    tally of the zero-filled list."""
    st, _ = displaced(sim, seed=4)
    p = sim.nl.params
    prd = st.box.prd.to(st.dtype)
    par = sim.pair_style.kernel_params()
    short, nshort, _ = tersoff_kernels.tersoff_short_reference(
        3.2 ** 2, p.ncells, st.x, st.mask, prd, 16)
    past = torch.arange(16)[None, :] >= nshort[:, None]
    junk = torch.where(past, st.capacity + 12345, short)
    f, tally = tersoff_kernels.tersoff_force_reference(par, st.x, short,
                                                       nshort, prd, True)
    f_j, tally_j = tersoff_kernels.tersoff_force_reference(par, st.x, junk,
                                                           nshort, prd, True)
    assert bool(past.any())
    assert torch.equal(f_j, f) and torch.equal(tally_j, tally)


def test_tally_forces_equal_the_step_pass(sim):
    st, _ = displaced(sim, seed=3)
    f_step = sim.force_fn(st, sim.nl, False, False)[0]
    f_tally = sim.force_fn(st, sim.nl, True, True)[0]
    torch.testing.assert_close(f_tally, f_step, rtol=0, atol=0)


def test_deck_runs_and_follows_the_reference():
    script, sim = port_sim()
    st = sim.state
    x0, v0 = by_tag(st, st.x), by_tag(st, st.v)
    script.one("run 20")
    assert sim.ntimestep == 20
    st = sim.state
    system = md.System(prd=st.box.prd.double(), mass=28.06, dt=0.001,
                       units="metal", model=REF_TERSOFF.Tersoff(
                           REF_TERSOFF.read(POT)), skin=1.0)
    x, v, _ = md.integrate(system, x0, v0, 20, REF)
    dx = by_tag(st, st.x) - x
    dx = dx - system.prd * torch.round(dx / system.prd)
    assert float(dx.abs().max()) < 1e-9
    vrms = float(torch.sqrt((v * v).sum(-1).mean()))
    assert float((by_tag(st, st.v) - v).abs().max()) < 1e-8 * vrms


def test_short_list_overflow_grows_and_retries(monkeypatch):
    """A list two wide overflows the setup pass (4 neighbours an atom):
    the grow path widens it alone, by 8 (or to the longest list, rounded
    up to 8, where that is more), and a list cut to three in mid-run
    overflows a segment, which is re-run from its snapshot with the list
    widened: the trajectory is the unplanted one's."""
    trace.enable()
    trace.reset()
    try:
        with monkeypatch.context() as m:
            m.setattr(sortedforce, "SHORT_CAP", 2)
            _, sim = port_sim()
        assert sim.short_cap == 10 and sim.nl.short_cap == 10
        grows = trace.snapshot()["counters"].get("neigh.short_grows")
        assert grows == 1
        cap = sim.nl.params.cell_cap
        sim.nl = dataclasses.replace(sim.nl, short_cap=3)
        sim.run(10, 10)
        assert sim.nl.short_cap == 11 and sim.nl.params.cell_cap == cap
        assert trace.snapshot()["counters"]["neigh.short_grows"] == 2
        assert trace.snapshot()["counters"]["segment.retries"] == 1
        assert trace.snapshot()["counters"]["pair.tersoff_tally_rows"] >= 2
    finally:
        trace.disable()
        trace.reset()
    _, plain = port_sim()
    plain.run(10, 10)
    torch.testing.assert_close(by_tag(sim.state, sim.state.x),
                               by_tag(plain.state, plain.state.x),
                               rtol=0, atol=1e-12)
