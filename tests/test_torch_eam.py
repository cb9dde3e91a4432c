"""PyTorch port, dense EAM (bench/in.eam) module by module against JAX.

Both packages read one synthetic funcfl file, the Sutton-Chen Cu stand-in
(`io/eam_reader.write_sutton_chen_funcfl`), written into a temporary
directory: bench/Cu_u3.eam is not in the repository. The JAX side runs as
its own tests run it on the CPU (the Pallas sweeps in interpret mode).

Tolerances: host tables (reader, splines, Chebyshev fits) are exact, both
packages compute them in numpy. The sweeps sum in another order than the
Newton-halved Pallas kernels and the roll path: rtol 1e-9 with atol
1e-10*max|value| on valid rows (as tests/test_slab_half.py); padding rows
exactly 0. Energy and virial of the thermo path: rtol 1e-10.

The thermo path on the sorted layout runs the tally sweeps (their plain
twins here) and is held against the JAX package and against the port's
own grid-roll path (`eamdense.grid_roll`, the path of cell buckets): f64
rtol 1e-10 with atol 1e-10*max; f32 forces and virial 1e-3*max|value|
(measured 5e-5: the roll path sums each pair once and every grid in f32)
and pe rtol 1e-5 (measured 1.6e-7).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.io import eam_reader as jax_eam_reader
from lammps_kokkos_port_tpu.models.pair_eam import (
    make_eam_funcfl as jax_make_eam_funcfl,
)
from lammps_kokkos_port_tpu.ops import eamdense as jax_eamdense
from lammps_kokkos_port_tpu.ops import pallas_eam, pallas_pair
from lammps_kokkos_port_tpu.presets import (
    eam_bulk_cu_sim as jax_eam_bulk_cu_sim,
)
from lammps_kokkos_port_tpu_torch import interop
from lammps_kokkos_port_tpu_torch.core.box import Box
from lammps_kokkos_port_tpu_torch.io.eam_reader import (
    read_funcfl,
    write_sutton_chen_funcfl,
)
from lammps_kokkos_port_tpu_torch.models.pair_eam import (
    make_eam_funcfl,
    make_eam_setfl,
)
from lammps_kokkos_port_tpu_torch.ops import eam_kernels, eamdense
from lammps_kokkos_port_tpu_torch.ops import sortedforce as sf
from lammps_kokkos_port_tpu_torch.presets import eam_bulk_cu_sim
from lammps_kokkos_port_tpu_torch.utils import trace

RTOL, ATOL_REL = 1e-9, 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once, and each worker's intra-op thread
    pool would otherwise claim every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pot(tmp_path_factory):
    return write_sutton_chen_funcfl(tmp_path_factory.mktemp("eam") / "sc.eam")


@pytest.fixture(scope="module")
def jax_sorted(pot):
    """The JAX sorted dense-EAM state after setup(), positions jittered by
    a seeded +-0.08 A, and the port's style and state made from it."""
    sim = jax_eam_bulk_cu_sim(cells=5, dtype=jnp.float64,
                              potential_path=pot)
    sim._list_mode_req = "sorted"
    sim.setup()
    st = sim.state
    valid = np.asarray(st.valid_mask)
    x = np.array(st.x)
    rng = np.random.default_rng(2025)
    x[valid] += rng.uniform(-0.08, 0.08, (int(valid.sum()), 3))
    st = st.replace(x=jnp.asarray(x))
    style = interop.pair_eam_from_arrays(
        interop.dataclass_to_arrays(sim.pair_style))
    port_state = interop.state_from_arrays(interop.dataclass_to_arrays(st))
    return sim, st, style, port_state


def _close(got, ref, valid, least=0.1):
    """Valid rows within RTOL / ATOL_REL*max, padding rows exactly 0; the
    largest valid |ref| above `least` (jittered: the values are real)."""
    assert np.abs(ref[valid]).max() > least
    np.testing.assert_allclose(got[valid], ref[valid], rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref[valid]).max())
    np.testing.assert_array_equal(got[~valid], 0.0)


def _squeezed(x, valid, params, prd, every=4):
    """Positions with one atom of every `every`-th cell moved 1.2 A from
    another of its cell (toward the cell's middle in x): below the fits'
    u_lo, so both rows' rho exceeds rho_hi and their embedding energy takes
    the linear extension."""
    x = np.array(x)
    cc = params.cell_cap
    edge = float(prd[0]) / params.ncells[0]
    for c in range(0, params.total_cells, every):
        i, j = c * cc + np.flatnonzero(valid[c * cc:(c + 1) * cc])[:2]
        x[j] = x[i]
        x[j, 0] += 1.2 if x[i, 0] % edge < edge / 2 else -1.2
    return x


def _port_cells(sim):
    p = sim.nl.params
    return sf.SortedCells(ago=0, nbuilds=1, overflow=torch.tensor(False),
                          params=p)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reader_and_spline_tables_match_jax(pot, dtype):
    ff, ref = read_funcfl(pot), jax_eam_reader.read_funcfl(pot)
    assert (ff.mass, ff.nrho, ff.nr, ff.dr, ff.cut) == (63.55, 500, 500,
                                                        0.01, 4.95)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(ff, f.name),
                                      getattr(ref, f.name), err_msg=f.name)

    port = make_eam_funcfl(1, {1: pot}, dtype=getattr(torch, dtype))
    jax_pair = jax_make_eam_funcfl(1, {1: pot}, dtype=getattr(jnp, dtype))
    d, d_ref = (interop.pair_eam_to_arrays(port),
                interop.dataclass_to_arrays(jax_pair))
    assert d.keys() <= d_ref.keys()
    for k, v in d.items():
        np.testing.assert_array_equal(v, d_ref[k], err_msg=k)
        assert np.asarray(v).dtype == np.asarray(d_ref[k]).dtype, k
    back = interop.pair_eam_to_arrays(interop.pair_eam_from_arrays(d_ref))
    for k, v in back.items():
        np.testing.assert_array_equal(v, d_ref[k], err_msg=k)


def test_poly_tables_match_jax(pot):
    port = make_eam_funcfl(1, {1: pot}, dtype=torch.float64)
    ref = jax_eamdense.build_poly_tables(
        jax_make_eam_funcfl(1, {1: pot}, dtype=jnp.float64))
    tabs = eamdense.build_poly_tables(port)
    assert tabs.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(tabs[k]),
                                      np.asarray(ref[k]), err_msg=k)
    assert port.poly_tables is port.poly_tables  # built once per style


@pytest.fixture(scope="module")
def jax_sweeps(jax_sorted):
    """The JAX package's sorted sweep on the jittered state: rho from
    rho_pallas (interpret mode), fp from compute_force_sorted's glue
    (pallas_eam.py:253-260) and the forces of force_pallas fed that fp;
    the port's tables and its planar grid of the same state."""
    sim, st, style, port_state = jax_sorted
    p = sim.nl.params
    nx, ny, nz = p.ncells
    cc, cap = p.cell_cap, st.capacity
    tabs = jax_eamdense.build_poly_tables(sim.pair_style)
    cutsq = float(sim.pair_style.cutmax) ** 2
    rtab = eam_kernels.rho_tab(style.poly_tables, cutsq)
    ftab = eam_kernels.force_tab(style.poly_tables, cutsq)

    ids = jnp.where(st.valid_mask, jnp.arange(cap, dtype=jnp.int32),
                    -1).astype(st.dtype)
    g = st.x.reshape(nx * ny, nz, cc, 3)
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    gi = ids.reshape(nx * ny, nz, cc)
    prd = st.box.prd.astype(st.dtype)
    rho_ref = pallas_eam.rho_pallas(rtab, p.ncells, cap, gx, gy, gz, gi, prd)
    s = jnp.sqrt(jnp.clip(rho_ref.reshape(-1), *tabs["rho_range"]))
    fp = jnp.where(st.valid_mask, jax_eamdense._clenshaw(
        tabs["Fp_s"], s, *tabs["s_range"]) / (2.0 * s), 0.0)
    fx, fy, fz = pallas_eam.force_pallas(ftab, p.ncells, cap, gx, gy, gz, gi,
                                         fp.reshape(nx * ny, nz, cc), prd)
    f_ref = np.stack([np.asarray(a).reshape(-1) for a in (fx, fy, fz)], -1)
    pg = sf.planar(port_state.x).reshape(3, p.total_cells, cc)
    return {"rtab": rtab, "ftab": ftab, "ncells": p.ncells, "g": pg,
            "prd": port_state.box.prd, "valid": port_state.valid_mask,
            "rho": np.asarray(rho_ref).reshape(-1),
            "fp": np.array(fp).reshape(-1), "f": f_ref}


def _launches():
    return (eam_kernels.eam_cell_rho.launches,
            eam_kernels.eam_cell_force.launches)


def test_sweep_twins_match_pallas_kernels(jax_sorted, jax_sweeps):
    """eam_cell_rho_reference against rho_pallas, and
    eam_cell_force_reference against force_pallas, fed the same fp
    channel."""
    st = jax_sorted[1]
    r = jax_sweeps
    valid = np.asarray(st.valid_mask)
    pg, pprd = r["g"], r["prd"]
    before = _launches()
    rho = eam_kernels.eam_cell_rho(r["rtab"], r["ncells"], pg[0], pg[1],
                                   pg[2], pprd)
    gfp = torch.from_numpy(r["fp"]).reshape(pg.shape[1:])
    f = eam_kernels.eam_cell_force(r["ftab"], r["ncells"], pg[0], pg[1],
                                   pg[2], gfp, pprd)
    # CPU tensors: the plain twins, no kernel launch
    assert before == _launches()
    _close(rho.reshape(-1).numpy(), r["rho"], valid)
    _close(f.reshape(3, -1).t().numpy(), r["f"], valid)


def test_fused_rho_fp_twin_matches_pallas_and_glue(jax_sorted, jax_sweeps):
    """eam_cell_rho_fp (the rho sweep with fp = F'(rho) in its epilogue)
    against rho_pallas followed by the JAX package's fp glue; fp is
    exactly 0 on the pad rows (`_close`)."""
    style = jax_sorted[2]
    r = jax_sweeps
    valid = np.asarray(jax_sorted[1].valid_mask)
    pg = r["g"]
    before = _launches()
    rho, fp = eam_kernels.eam_cell_rho_fp(
        r["rtab"], eam_kernels.fp_tab(style.poly_tables), r["ncells"], pg[0],
        pg[1], pg[2], r["valid"], r["prd"])
    assert before == _launches()
    assert rho.shape == fp.shape == pg.shape[1:]
    _close(rho.reshape(-1).numpy(), r["rho"], valid)
    _close(fp.reshape(-1).numpy(), r["fp"], valid, least=0.01)
    assert (~valid).sum() > 0


def test_fp_follows_the_valid_mask(jax_sorted, jax_sweeps):
    """fp is 0 exactly where the mask is false, pads and real rows alike,
    and the fp of the other rows does not depend on the mask."""
    style = jax_sorted[2]
    r = jax_sweeps
    pg = r["g"]
    ftab = eam_kernels.fp_tab(style.poly_tables)
    assert ftab[0] == tuple(style.poly_tables["Fp_s"])
    assert len(ftab[0]) == eam_kernels.NFP
    valid = r["valid"].clone()
    real = torch.nonzero(valid).reshape(-1)
    valid[real[::7]] = False
    args = (r["rtab"], ftab, r["ncells"], pg[0], pg[1], pg[2])
    _, fp_all = eam_kernels.eam_cell_rho_fp(*args, r["valid"], r["prd"])
    _, fp = eam_kernels.eam_cell_rho_fp(*args, valid, r["prd"])
    fp, fp_all = fp.reshape(-1), fp_all.reshape(-1)
    assert torch.equal(fp[~valid], torch.zeros_like(fp[~valid]))
    assert torch.equal(fp[valid], fp_all[valid])
    assert bool((fp[valid] != 0).all())
    with pytest.raises(ValueError, match="valid"):
        eam_kernels.eam_cell_rho_fp(*args, valid.to(torch.uint8), r["prd"])
    with pytest.raises(ValueError, match="valid"):
        eam_kernels.eam_cell_rho_fp(*args, valid[:-1], r["prd"])


def test_kernel_sources_share_the_pad_constants():
    """Both sorted-layout kernels read the pad sentinel from one header
    (csrc/sorted_grid.cuh), whose kPadPos and kPadStep equal
    ops/sortedforce's; neither source keeps a copy of its own."""
    from lammps_kokkos_port_tpu_torch.ops import pair_kernels

    header = eam_kernels.SOURCE.parent / "sorted_grid.cuh"
    consts = dict(re.findall(r"constexpr double (kPad\w+) = ([0-9.e+]+);",
                             header.read_text()))
    assert (float(consts["kPadPos"]), float(consts["kPadStep"])) == (
        sf.PAD_POS, sf.PAD_STEP)
    for source in (eam_kernels.SOURCE, pair_kernels.SOURCE):
        text = source.read_text()
        assert '#include "sorted_grid.cuh"' in text
        assert "kPadPos =" not in text and "kPadStep =" not in text


@pytest.mark.parametrize("dispatch", ["pallas", "roll"])
def test_force_pass_matches_jax(jax_sorted, monkeypatch, dispatch):
    """The port's force-only pass (the two sweeps and the fp glue) against
    JAX eamdense.compute on its Pallas dispatch, and on its grid-roll path
    (the one it takes above 300k rows, forced by a row limit of 1)."""
    sim, st, style, port_state = jax_sorted
    if dispatch == "roll":
        monkeypatch.setattr(pallas_pair, "_VMEM_ROW_LIMIT", 1)
    f_ref = np.asarray(jax_eamdense.compute(sim.pair_style, st, sim.nl,
                                            False, False)[0])
    f, pe, vir = eamdense.compute(style, port_state, _port_cells(sim), False,
                                  False)
    assert pe is None and vir is None
    _close(f.numpy(), f_ref, np.asarray(st.valid_mask))


def test_thermo_path_matches_jax(jax_sorted):
    """Energy and virial (the grid-roll path of thermo steps)."""
    sim, st, style, port_state = jax_sorted
    f_ref, pe_ref, vir_ref = jax.device_get(jax_eamdense.compute(
        sim.pair_style, st, sim.nl, True, True))
    f, pe, vir = eamdense.compute(style, port_state, _port_cells(sim), True,
                                  True)
    _close(f.numpy(), np.asarray(f_ref), np.asarray(st.valid_mask))
    np.testing.assert_allclose(pe.item(), float(pe_ref), rtol=1e-10)
    np.testing.assert_allclose(vir.numpy(), np.asarray(vir_ref), rtol=1e-10)
    assert abs(pe.item()) > 1.0 and np.abs(vir.numpy()).max() > 1.0


def test_unported_paths_raise(pot):
    """EAM in list mode "auto" would run the JAX package's exact-spline
    matrix engine: the port refuses instead of switching physics. The
    matrix path itself and eam/alloy refuse too."""
    sim = eam_bulk_cu_sim(cells=5, dtype=torch.float64, potential_path=pot,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="matrix"):
        sim.setup()
    with pytest.raises(NotImplementedError, match="slice 6"):
        sim.pair_style.compute(sim.state, None, False, False)
    with pytest.raises(NotImplementedError):
        make_eam_setfl(1, pot)


def test_non_cpu_tensors_never_reach_the_twins(pot):
    """A tensor off the CPU goes to the kernel or raises (meta tensors: no
    kernel for that device)."""
    tabs = make_eam_funcfl(1, {1: pot}, dtype=torch.float64).poly_tables
    g = torch.zeros(27, 8, dtype=torch.float64, device="meta")
    prd = torch.ones(3, dtype=torch.float64, device="meta")
    with pytest.raises(NotImplementedError, match="device"):
        eam_kernels.eam_cell_rho(eam_kernels.rho_tab(tabs, 24.5), (3, 3, 3),
                                 g, g, g, prd)
    with pytest.raises(NotImplementedError, match="device"):
        eam_kernels.eam_cell_force(eam_kernels.force_tab(tabs, 24.5),
                                   (3, 3, 3), g, g, g, g, prd)
    valid = torch.ones(27 * 8, dtype=torch.bool, device="meta")
    with pytest.raises(NotImplementedError, match="device"):
        eam_kernels.eam_cell_rho_fp(eam_kernels.rho_tab(tabs, 24.5),
                                    eam_kernels.fp_tab(tabs), (3, 3, 3), g, g,
                                    g, valid, prd)
    with pytest.raises(NotImplementedError, match="device"):
        eam_kernels.eam_cell_rho_tally(
            eam_kernels.rho_tab(tabs, 24.5), eam_kernels.fp_tab(tabs),
            eam_kernels.embed_tab(tabs), (3, 3, 3), g, g, g, valid, prd)
    with pytest.raises(NotImplementedError, match="device"):
        eam_kernels.eam_cell_force_tally(
            eam_kernels.force_tab(tabs, 24.5), eam_kernels.phi_tab(tabs),
            (3, 3, 3), g, g, g, g, g, prd)


def test_thermo_path_above_rho_hi_matches_jax(jax_sorted):
    """Energy and virial where rows' rho exceeds rho_hi (pairs 1.2 A apart,
    `_squeezed`): the linear extension of the embedding energy, against the
    JAX package's thermo path."""
    sim, st, style, port_state = jax_sorted
    valid = np.asarray(st.valid_mask)
    x = _squeezed(st.x, valid, sim.nl.params, st.box.prd)
    st = st.replace(x=jnp.asarray(x))
    port_state = port_state.replace(x=torch.from_numpy(x))
    f_ref, pe_ref, vir_ref = jax.device_get(jax_eamdense.compute(
        sim.pair_style, st, sim.nl, True, True))
    cl = _port_cells(sim)
    f, pe, vir = eamdense.compute(style, port_state, cl, True, True)
    _close(f.numpy(), np.asarray(f_ref), valid)
    np.testing.assert_allclose(pe.item(), float(pe_ref), rtol=1e-10)
    np.testing.assert_allclose(vir.numpy(), np.asarray(vir_ref), rtol=1e-10,
                               atol=1e-10 * np.abs(vir_ref).max())
    p = sim.nl.params
    g = sf.planar(port_state.x).reshape(3, p.total_cells, p.cell_cap)
    rho = eam_kernels.eam_cell_rho(
        eam_kernels.rho_tab(style.poly_tables, float(style.cutmax) ** 2),
        p.ncells, g[0], g[1], g[2], port_state.box.prd)
    assert int((rho.reshape(-1) > style.poly_tables["rho_range"][1]).sum()
               ) >= 2 * len(range(0, p.total_cells, 4))


@pytest.fixture(scope="module")
def port_sorted(pot):
    """dtype -> the port's own sorted EAM simulation (cells 5, CPU) after
    setup() and its state with the real rows jittered by a seeded +-0.08
    A."""
    out = {}
    for dt in (torch.float32, torch.float64):
        sim = eam_bulk_cu_sim(cells=5, dtype=dt, potential_path=pot,
                              device="cpu", list_mode="sorted")
        sim.setup()
        st = sim.state
        rng = np.random.default_rng(7)
        x = st.x.double().numpy().copy()
        valid = st.valid_mask.numpy()
        x[valid] += rng.uniform(-0.08, 0.08, (int(valid.sum()), 3))
        out[dt] = sim, st.replace(x=torch.from_numpy(x).to(dt))
    return out


@pytest.mark.parametrize("squeeze", [False, True],
                         ids=["jittered", "above_rho_hi"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tally_twin_matches_grid_roll(port_sorted, dtype, squeeze):
    """The sorted thermo path (the tally sweeps' twins) against the port's
    grid-roll path on the same state: forces, pe and virial."""
    sim, st = port_sorted[dtype]
    valid = st.valid_mask.numpy()
    if squeeze:
        st = st.replace(x=torch.from_numpy(_squeezed(
            st.x, valid, sim.nl.params, st.box.prd)).to(dtype))
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    before = (eam_kernels.eam_cell_rho_tally.launches,
              eam_kernels.eam_cell_force_tally.launches)
    f, pe, vir = eamdense.compute(sim.pair_style, st, sim.nl, True, True)
    assert before == (eam_kernels.eam_cell_rho_tally.launches,
                      eam_kernels.eam_cell_force_tally.launches)
    f_ref, pe_ref, vir_ref = eamdense.grid_roll(sim.pair_style, st, sim.nl,
                                                True, True)
    assert pe.dtype == vir.dtype == f.dtype == dtype and vir.shape == (6,)
    np.testing.assert_allclose(f.numpy()[valid], f_ref.numpy()[valid],
                               rtol=tol,
                               atol=tol * np.abs(f_ref.numpy()).max())
    np.testing.assert_allclose(pe.item(), pe_ref.item(),
                               rtol=1e-10 if dtype == torch.float64 else 1e-5)
    np.testing.assert_allclose(vir.numpy(), vir_ref.numpy(), rtol=tol,
                               atol=tol * np.abs(vir_ref.numpy()).max())
    assert abs(pe.item()) > 1.0 and np.abs(vir.numpy()).max() > 1.0


def test_tally_twins_hold_their_planes(port_sorted):
    """The tally twins' planes: e is F(rho) on valid rows and 0 elsewhere,
    the force tally's forces are the force twin's, and its planes are pe
    and the virial's halves per row."""
    sim, st = port_sorted[torch.float64]
    tabs = sim.pair_style.poly_tables
    cutsq = float(sim.pair_style.cutmax) ** 2
    p = sim.nl.params
    g = sf.planar(st.x).reshape(3, p.total_cells, p.cell_cap)
    args = (p.ncells, g[0], g[1], g[2])
    rho, fp, e = eam_kernels.eam_cell_rho_tally(
        eam_kernels.rho_tab(tabs, cutsq), eam_kernels.fp_tab(tabs),
        eam_kernels.embed_tab(tabs), *args, st.valid_mask, st.box.prd)
    valid = st.valid_mask.reshape(e.shape)
    assert torch.equal(e[~valid], torch.zeros_like(e[~valid]))
    assert bool((e[valid] < 0).all())
    torch.testing.assert_close(
        e, eamdense.embedding_energy(tabs, rho, fp, valid), rtol=0, atol=0)
    f, tally = eam_kernels.eam_cell_force_tally(
        eam_kernels.force_tab(tabs, cutsq), eam_kernels.phi_tab(tabs), *args,
        fp, e, st.box.prd)
    assert tally.shape == (7, *e.shape)
    torch.testing.assert_close(f, eam_kernels.eam_cell_force(
        eam_kernels.force_tab(tabs, cutsq), *args, fp, st.box.prd),
        rtol=0, atol=0)
    _, pe, vir = eamdense.compute(sim.pair_style, st, sim.nl, True, True)
    sums = tally.reshape(7, -1).sum(1)
    assert sums[0].item() == pytest.approx(pe.item(), rel=1e-13)
    np.testing.assert_allclose(sums[1:].numpy(), vir.numpy(), rtol=1e-13)
    with pytest.raises(ValueError, match="channels"):
        eam_kernels.eam_cell_force_tally(
            eam_kernels.force_tab(tabs, cutsq), eam_kernels.phi_tab(tabs),
            *args, fp, e.float(), st.box.prd)


def test_energy_pass_counters(port_sorted, pot):
    """`pair.eam_tally_rows` counts the sorted layout's energy passes (the
    tally sweeps), `pair.eam_roll_rows` the cell buckets' (the grid-roll
    path); force-only passes count on neither; pe and virial come back
    only where asked for."""
    sim, st = port_sorted[torch.float64]
    cell = eam_bulk_cu_sim(cells=5, dtype=torch.float64, potential_path=pot,
                           device="cpu", list_mode="cell")
    cell.setup()
    trace.reset()
    trace.enable()
    try:
        f, pe, vir = eamdense.compute(sim.pair_style, st, sim.nl, True, False)
        assert pe is not None and vir is None
        f, pe, vir = eamdense.compute(sim.pair_style, st, sim.nl, False, True)
        assert pe is None and vir.shape == (6,)
        eamdense.compute(sim.pair_style, st, sim.nl, False, False)
        assert trace.snapshot()["counters"] == {"pair.eam_tally_rows": 2}
        eamdense.compute(cell.pair_style, cell.state, cell.nl, False, False)
        _, pe, vir = eamdense.compute(cell.pair_style, cell.state, cell.nl,
                                      True, True)
        assert pe is not None and vir is not None
        assert trace.snapshot()["counters"] == {"pair.eam_tally_rows": 2,
                                                "pair.eam_roll_rows": 1}
    finally:
        trace.disable()
        trace.reset()


def test_tally_sums_leave_out_pads_that_meet(port_sorted):
    """A (3, 3, 3) x cc 1 sorted grid whose box edge is 26 * PAD_STEP + 1:
    the pads of rows 0 and 26 meet across the periodic corner (r2 = 3), so
    the twins give them a pair energy and a virial. The thermo path sums
    only the valid rows' planes, as the grid-roll path masks pads: pe and
    virial equal grid_roll's. (x, mask and box are replaced; the other
    per-row fields are not read.)"""
    sim, st = port_sorted[torch.float64]
    edge = 26 * sf.PAD_STEP + 1.0
    x = sf._pad_x(27, torch.float64, "cpu")[:, None].repeat(1, 3)
    mask = torch.zeros(27, dtype=torch.int32)
    # rows 1-25 hold atoms off the box's diagonal (where the pads lie) and
    # far from each other: no pair of any kind reaches them
    for row in range(1, 26):
        c = np.array([row // 9, row // 3 % 3, row % 3])
        x[row] = torch.from_numpy((c + 0.5) * edge / 3 + [10.0, -20.0, 30.0])
        mask[row] = 1
    box = Box.create([0.0] * 3, [edge] * 3)
    corner = st.replace(x=x, mask=mask, box=box)
    params = dataclasses.replace(sim.nl.params, ncells=(3, 3, 3), cell_cap=1)
    cl = sf.SortedCells(ago=0, nbuilds=1, overflow=torch.tensor(False),
                        params=params)
    _, pe, vir = eamdense.compute(sim.pair_style, corner, cl, True, True)
    _, pe_ref, vir_ref = eamdense.grid_roll(sim.pair_style, corner, cl, True,
                                            True)
    assert pe.item() == pytest.approx(pe_ref.item(), rel=1e-12)
    np.testing.assert_allclose(vir.numpy(), vir_ref.numpy(), rtol=0,
                               atol=1e-12)
    tabs = sim.pair_style.poly_tables
    cutsq = float(sim.pair_style.cutmax) ** 2
    g = sf.planar(x).reshape(3, 27, 1)
    args = ((3, 3, 3), g[0], g[1], g[2])
    _, fp, e = eam_kernels.eam_cell_rho_tally(
        eam_kernels.rho_tab(tabs, cutsq), eam_kernels.fp_tab(tabs),
        eam_kernels.embed_tab(tabs), *args, mask != 0, box.prd)
    _, tally = eam_kernels.eam_cell_force_tally(
        eam_kernels.force_tab(tabs, cutsq), eam_kernels.phi_tab(tabs), *args,
        fp, e, box.prd)
    pads = tally.reshape(7, 27)[:, [0, 26]]
    assert bool((pads[0] != 0).all()) and bool((pads[1:4] != 0).all())
    sums = eam_kernels.tally_sums(tally, mask != 0)
    assert sums[0].item() == pytest.approx(pe_ref.item(), rel=1e-12)
    assert (tally.reshape(7, -1).sum(1)[0] - sums[0]).abs() > 1e-3
