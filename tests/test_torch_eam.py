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
"""

import dataclasses

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


def _close(got, ref, valid):
    """Valid rows within RTOL / ATOL_REL*max, padding rows exactly 0."""
    assert np.abs(ref[valid]).max() > 0.1  # jittered: values are real
    np.testing.assert_allclose(got[valid], ref[valid], rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref[valid]).max())
    np.testing.assert_array_equal(got[~valid], 0.0)


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


def test_sweep_twins_match_pallas_kernels(jax_sorted):
    """eam_cell_rho_reference against rho_pallas, and
    eam_cell_force_reference against force_pallas, fed the same fp
    channel."""
    sim, st, style, port_state = jax_sorted
    p = sim.nl.params
    nx, ny, nz = p.ncells
    cc, cap = p.cell_cap, st.capacity
    valid = np.asarray(st.valid_mask)
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
    pprd = port_state.box.prd
    before = (eam_kernels.eam_cell_rho.launches,
              eam_kernels.eam_cell_force.launches)
    rho = eam_kernels.eam_cell_rho(rtab, p.ncells, pg[0], pg[1], pg[2], pprd)
    gfp = torch.from_numpy(np.array(fp)).reshape(p.total_cells, cc)
    f = eam_kernels.eam_cell_force(ftab, p.ncells, pg[0], pg[1], pg[2], gfp,
                                   pprd)
    # CPU tensors: the plain twins, no kernel launch
    assert before == (eam_kernels.eam_cell_rho.launches,
                      eam_kernels.eam_cell_force.launches)
    _close(rho.reshape(-1).numpy(), np.asarray(rho_ref).reshape(-1), valid)
    _close(f.reshape(3, -1).t().numpy(), f_ref, valid)


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
