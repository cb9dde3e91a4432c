"""PyTorch port, SNAP tungsten (LAMMPS examples/snap/in.snap.W.2940:
pair_style hybrid/overlay zbl 4.0 4.8 snap, twojmax 8) on the CPU.

The port's sorted path (the plain twins of ops/snap_kernels) against the
benchmark's plain reference (bench_port/reference/pair_hybrid_overlay.py,
loaded from its file: its own Clebsch-Gordan and index code, the energy as
the full U contraction, autograd forces) and the JAX package's
`make_snap` and `make_zbl` under its `PairHybridOverlay` (jax.grad of one
energy over its neighbour matrix), on the benchmark's deck and seeded
coefficients (bench_port/potentials/snap-seeded.py), in float64.

Size: the deck at nrep 6, 6 x 6 x 6 bcc cells, 432 atoms. The published
nrep 4 (128 atoms, a 12.7 A box) holds two cells of the cutoff and skin
(5.8 A) a side, and the port's sorted layout needs three (ROADMAP L1).
Where SNAP is compared, its coefficients are scaled up (`STRONG`, 25 times
the benchmark's scale): SNAP's forces are then about seven times ZBL's, so
a fault in SNAP cannot hide under ZBL's share.

Tolerances. Port, reference and JAX compute the same sums in other orders
(the port's half of U with the Y table and the forward dU/dr recursion,
the reference's full contraction and autograd, JAX's trilinear table and
jax.grad): forces within 1e-10 of the rms force (measured 5e-15 against
the reference), pe and the six virial terms within 1e-12 relative (the
virial with atol 1e-12 of its largest term). The twins' forces against a
central difference of their energy, h = 1e-5 A: truncation h^2 f''' and
rounding 1e-16 E / h are both below 1e-6 of a force of 1 eV/A; rtol and
atol 1e-6. Y against autograd of the energy in U: 1e-12 of the largest
|Y| (the same terms summed in another order). The deck's 20 steps through
`LammpsScript`: the total energy at step 20 within 1e-6 of the pe's
magnitude at step 0 (velocity Verlet at dt 0.5 fs drifts about 1e-8 here).
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_port import decks
from bench_port.reference.models import REF
from bench_port.reference.neighbors import half_pairs
from lammps_kokkos_port_tpu.core.box import Box as JBox
from lammps_kokkos_port_tpu.core.state import create_state as jcreate_state
from lammps_kokkos_port_tpu.models.pair_snap import make_snap as jmake_snap
from lammps_kokkos_port_tpu.models.pair_zbl import (
    PairHybridOverlay as JOverlay,
)
from lammps_kokkos_port_tpu.models.pair_zbl import make_zbl as jmake_zbl
from lammps_kokkos_port_tpu.ops import neighbor as jnbr
from lammps_kokkos_port_tpu_torch.models import pair_snap
from lammps_kokkos_port_tpu_torch.models.forcefield import HybridOverlay
from lammps_kokkos_port_tpu_torch.ops import snap_kernels as sk
from lammps_kokkos_port_tpu_torch.ops import sortedforce
from lammps_kokkos_port_tpu_torch.ops import tersoff_kernels as tk
from lammps_kokkos_port_tpu_torch.script import LammpsScript, ScriptError
from lammps_kokkos_port_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "bench_port" / "configs"
CONFIG = json.loads((CONFIGS / "snap-w-fp64.json").read_text())
NREP = "1.5"       # the deck's 4 * x cells a side: 6
STRONG = 25.0      # SNAP's coefficients scaled up where SNAP is compared


def _reference_module():
    path = REPO / "bench_port" / "reference" / "pair_hybrid_overlay.py"
    spec = importlib.util.spec_from_file_location("ref_pair_overlay", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_OVERLAY = _reference_module()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_potential(directory, scale=1.0):
    """The benchmark's include file (and its .snapcoeff, .snapparam) in
    `directory`, the coefficients times `scale`."""
    conf = json.loads(json.dumps(CONFIG))
    conf["potential"]["beta_scale"] *= scale
    return conf, decks.potential(conf, CONFIGS, Path(directory))


def port_script(directory, scale=1.0, overlay=None):
    """The deck at 432 atoms through `LammpsScript` up to its `run`, and a
    `run 0`; `overlay` replaces the include file's pair lines."""
    Path(directory).mkdir(exist_ok=True)
    conf, pot = write_potential(directory, scale)
    lines, _ = decks.make_deck(conf, 4928458, pot, CONFIGS)
    if overlay is not None:
        inc = Path(pot).read_text().splitlines()
        body = [ln for ln in inc
                if not ln.startswith(("pair_", "zbl", "snap"))]
        coeff = next(ln for ln in inc
                     if " snap " in ln and "pair_coeff" in ln)
        Path(pot).write_text("\n".join(body + overlay(coeff)) + "\n")
    deck = Path(directory) / "deck.in"
    deck.write_text("\n".join(lines) + "\n")
    script = LammpsScript(dtype=torch.float64, device="cpu",
                          list_mode="sorted",
                          var_overrides={"x": NREP, "y": NREP, "z": NREP})
    with contextlib.redirect_stdout(io.StringIO()):
        script.file(str(deck))
        script.one("run 0")
    return script, pot


def by_tag(state, a):
    valid = state.valid_mask
    return a[valid][torch.argsort(state.tag[valid].long())]


def displaced(state, seed, scale=0.05):
    """The state with each atom moved by a seeded normal of `scale` A a
    component (by tag), and the displacement by tag."""
    disp = torch.tensor(np.random.default_rng(seed).normal(
        scale=scale, size=(state.nlocal, 3)))
    x = state.x.clone()
    rows = torch.nonzero(state.valid_mask).flatten()
    x[rows] += disp[state.tag[rows].long() - 1]
    return state.replace(x=x), disp


@pytest.fixture(scope="module")
def strong(tmp_path_factory):
    """The deck's simulation with SNAP's coefficients times STRONG, and its
    include file (the short list set wide enough for bcc W at setup)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sortedforce, "SHORT_CAP", 32)
        script, pot = port_script(tmp_path_factory.mktemp("strong"), STRONG)
    return script.sim, pot


@pytest.fixture(scope="module")
def strong_eval(strong):
    """A displaced state, the port's (f, pe, virial) on it and the same by
    tag."""
    sim, pot = strong
    st, disp = displaced(sim.state, 0)
    f, pe, _, vir = sim.force_fn(st, sim.nl, True, True)
    return st, disp, by_tag(st, f), float(pe), vir


def test_tables_and_files(tmp_path):
    _, pot = write_potential(tmp_path)
    conf = REF_OVERLAY.read_include(pot)
    style = pair_snap.make_snap(1, conf["snapcoeff"], conf["snapparam"],
                                ["W"])
    assert (style.twojmax, style.rcutfac, style.rfac0, style.radelem,
            style.wj, style.bzeroflag) == (8, 4.73442, 0.99363, 0.5, 1.0, 0)
    assert len(style.beta) == len(pair_snap.idxb(8)) == 55
    assert style.beta0 == 0.0 and style.nhalf == sk.half_count(8) == 155
    assert len(pair_snap.bispectrum_terms(8)[0]) == 16804
    entries, coef = style.table
    out = sk.y_terms(entries, coef, torch.float64, "cpu")[4]
    assert entries.size == coef.size and bool((out.diff() >= 0).all())
    # the port's Clebsch-Gordan list against the reference's Racah formula
    cg, block = pair_snap.clebsch_gordan(8)
    for (j1, j2, j), off in list(block.items())[::7]:
        ref = REF_OVERLAY.cg_tensor(j1, j2, j)
        for m1 in range(j1 + 1):
            for m2 in range(j2 + 1):
                m = (2 * m1 - j1 + 2 * m2 - j2 + j) // 2
                want = float(ref[m1, m2, m]) if 0 <= m <= j else 0.0
                assert cg[off + m1 * (j2 + 1) + m2] == pytest.approx(
                    want, abs=1e-14), (j1, j2, j, m1, m2)
    with pytest.raises(NotImplementedError, match="single element"):
        pair_snap.make_snap(2, conf["snapcoeff"], conf["snapparam"],
                            ["W", "W"])
    param = tmp_path / "q.snapparam"
    param.write_text(Path(conf["snapparam"]).read_text().replace(
        "quadraticflag 0", "quadraticflag 1"))
    with pytest.raises(NotImplementedError, match="quadraticflag"):
        pair_snap.make_snap(1, conf["snapcoeff"], str(param), ["W"])


@pytest.mark.parametrize("words,err,match", [
    ("pair_style hybrid/overlay zbl 4.0 4.8 lj/cut 2.5", NotImplementedError,
     "lj/cut"),
    ("pair_style hybrid/overlay zbl 4.0 4.8 zbl 4.0 4.8",
     NotImplementedError, "twice"),
    ("pair_style snap 1", NotImplementedError, "no arguments"),
    ("pair_style zbl 4.0", ScriptError, "inner and an outer"),
    ("neigh_modify once yes", ScriptError, "once"),
    ("neigh_modify every 1 cluster yes", ScriptError, "cluster")])
def test_unported_forms_raise(words, err, match):
    with pytest.raises(err, match=match):
        LammpsScript(dtype=torch.float64, device="cpu").one(words)


def test_port_matches_reference(strong, strong_eval):
    _, pot = strong
    st, _, f, pe, vir = strong_eval
    conf = dict(CONFIG, mass=183.84)
    model, _ = REF_OVERLAY.build(conf, pot, 1e-12)
    x = by_tag(st, st.x)
    prd = st.box.prd.double()
    res = model.evaluate(x, prd, half_pairs(x, prd, model.cutoff + 1.0),
                         REF, True)
    rms = float(res.f.pow(2).sum(-1).mean().sqrt())
    np.testing.assert_allclose(f.numpy(), res.f.numpy(), rtol=0,
                               atol=1e-10 * rms)
    assert pe == pytest.approx(res.pe, rel=1e-12)
    vscale = max(abs(v) for v in res.virial)
    np.testing.assert_allclose(vir.numpy(), res.virial, rtol=1e-12,
                               atol=1e-12 * vscale)


def test_port_matches_jax(strong, strong_eval):
    sim, pot = strong
    st0 = sim.state
    st, disp, f, pe, vir = strong_eval
    conf = REF_OVERLAY.read_include(pot)
    jpair = JOverlay(styles=(
        jmake_zbl(1, 4.0, 4.8, {1: 74.0}, qqr2e=14.399645),
        jmake_snap(1, conf["snapcoeff"], conf["snapparam"], ["W"])),
        ntypes=1)
    x0 = by_tag(st0, st0.x).numpy()
    prd = st0.box.prd.double().numpy()
    jst = jcreate_state(x0, JBox.create(np.zeros(3), prd, dtype=jnp.float64),
                        types=np.ones(len(x0), dtype=np.int32),
                        masses=np.array([1.0, 183.84]), units_name="metal",
                        dtype=jnp.float64)
    # the JAX neighbour matrix within the cutoff and skin, built directly
    # (its Simulation.setup takes some 40 s here in eager mode)
    params = jnbr.size_for_system(jst, cutneigh=4.8 + 1.0, skin=1.0)
    nl = jax.jit(lambda s: jnbr.build(s, params))(jst)
    assert not bool(nl.overflow)
    tags = np.asarray(jst.tag)
    jvalid = np.asarray(jst.mask) != 0
    jx = np.asarray(jst.x).copy()
    jx[jvalid] += disp.numpy()[tags[jvalid] - 1]
    jf, je, jvir = jax.jit(lambda s: jpair.compute(s, nl, True, True))(
        jst.replace(x=jnp.asarray(jx)))
    jf = np.asarray(jf)[jvalid][np.argsort(tags[jvalid])]
    rms = float(np.sqrt((jf ** 2).sum(-1).mean()))
    np.testing.assert_allclose(f.numpy(), jf, rtol=0, atol=1e-10 * rms)
    assert pe == pytest.approx(float(je), rel=1e-12)
    jvir = np.asarray(jvir)
    np.testing.assert_allclose(vir.numpy(), jvir, rtol=1e-12,
                               atol=1e-12 * np.abs(jvir).max())


def _energy(sim, state):
    """The twins' energy of `state`: SNAP's ui and yi tally, ZBL's tally."""
    snap, zbl = sorted(sim.pair_style.styles, key=lambda s: s.short_rank)
    lists = tk.short_lists(4.8, state, sim.nl, "snap")
    x, prd, short, nshort = lists
    par = snap.kernel_params()
    u = sk.snap_ui(par, x, state.mask, short, nshort, prd)
    _, e = sk.snap_yi_reference(par, snap.table, state.mask, u, tally=True)
    _, tally = sk.zbl_pair_reference(zbl.kernel_params(), x, state.mask,
                                     short, nshort, prd, True)
    return float(e.sum() + tally[0].sum())


def test_forces_are_the_twins_energy_gradient(strong, strong_eval):
    sim, _ = strong
    st, _, f, _, _ = strong_eval
    h = 1e-5
    rows = torch.nonzero(st.valid_mask).flatten()
    for row, d in ((int(rows[7]), 0), (int(rows[300]), 2)):
        e = []
        for s in (h, -h):
            x = st.x.clone()
            x[row, d] += s
            e.append(_energy(sim, st.replace(x=x)))
        fd = -(e[0] - e[1]) / (2 * h)
        tag = int(st.tag[row]) - 1
        assert float(f[tag, d]) == pytest.approx(fd, rel=1e-6, abs=1e-6)


def test_y_is_the_gradient_of_the_energy_in_u(strong, strong_eval):
    """Y (the yi twin, from the folded Y table) against autograd of E(U) =
    E_0 + sum_t beta_b w_t Re[U1 U2 conj(U3)] over the half of U, the
    full U made from the half by the symmetry; and the tally's energy (1/3
    sum Re[conj(Y) U]) equal to that sum."""
    sim, _ = strong
    st = strong_eval[0]
    snap = min(sim.pair_style.styles, key=lambda s: s.short_rank)
    x, prd, short, nshort = tk.short_lists(4.8, st, sim.nl, "snap")
    par = snap.kernel_params()
    u = sk.snap_ui(par, x, st.mask, short, nshort, prd)
    y, e = sk.snap_yi_reference(par, snap.table, st.mask, u, tally=True)
    rows = torch.nonzero(st.valid_mask).flatten()[:16]
    uh = u[rows].clone().requires_grad_(True)
    full = sk._full_from_half(torch.view_as_complex(uh), 8)
    u1, u2, u3, b, w = (torch.as_tensor(t) for t in
                        pair_snap.bispectrum_terms(8))
    c = torch.as_tensor(snap.beta, dtype=torch.float64)[b] * w
    energy = par[8] + (c * (full[:, u1] * full[:, u2]
                            * full[:, u3].conj()).real).sum(1)
    (grad,) = torch.autograd.grad(energy.sum(), uh)
    scale = float(y[rows].abs().max())
    torch.testing.assert_close(y[rows], grad, rtol=0, atol=1e-12 * scale)
    torch.testing.assert_close(e[rows], energy.detach(), rtol=1e-12,
                               atol=0)


def test_deck_runs_and_conserves_energy(tmp_path):
    trace.enable()
    trace.reset()
    try:
        script, _ = port_script(tmp_path)
        with contextlib.redirect_stdout(io.StringIO()):
            rows = script.cmd_run(["20"])
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    assert script.sim.ntimestep == 20 and rows[-1]["natoms"] == 432
    assert [r["step"] for r in rows] == [0, 10, 20]
    drift = abs(rows[-1]["etotal"] - rows[0]["etotal"])
    assert drift < 1e-6 * abs(rows[0]["epair"])
    spans = snap["spans"]
    for name in ("pair.snap", "pair.snap.short", "pair.snap.ui",
                 "pair.snap.yi", "pair.snap.deidrj", "pair.zbl"):
        assert spans[name]["count"] > 0, name
    assert "pair.zbl.short" not in spans
    assert snap["counters"]["pair.snap_tally_rows"] >= 3
    assert snap["counters"]["neigh.short_grows"] == 1


@pytest.mark.parametrize("alone", ["zbl", "snap"])
def test_overlay_of_one_is_the_plain_style(tmp_path, alone):
    """hybrid/overlay with one sub-style gives the plain style's forces,
    energy and virial, to the last bit."""
    def only(coeff):
        if alone == "zbl":
            return ["pair_style hybrid/overlay zbl 4.0 4.8",
                    "pair_coeff 1 1 zbl 74 74"]
        return ["pair_style hybrid/overlay snap", coeff]

    def plain(coeff):
        if alone == "zbl":
            return ["pair_style zbl 4.0 4.8", "pair_coeff * * 74 74"]
        return ["pair_style snap", coeff.replace(" snap ", " ")]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(sortedforce, "SHORT_CAP", 32)
        a, _ = port_script(tmp_path / "a", overlay=only)
        b, _ = port_script(tmp_path / "b", overlay=plain)
    assert isinstance(a.sim.pair_style, HybridOverlay)
    assert not isinstance(b.sim.pair_style, HybridOverlay)
    st, _ = displaced(a.sim.state, 5)
    got = a.sim.force_fn(st, a.sim.nl, True, True)
    want = b.sim.force_fn(st, b.sim.nl, True, True)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
