"""PyTorch port, list mode "cell" (ops/cellforce, ops/cell_kernels) against
the JAX package.

fp64 on CPU, cells 6 (864 atoms, a 3x3x3 cell grid) and 7 (1372 atoms in
a capacity of 1376, a 4x4x4 grid: padded rows fill the dead bucket row).
  - build_cell: buckets and stencil bit for bit;
  - the plain energy/virial path (thermo rows) at rtol 1e-10;
  - the K6 twin `lj_cell_dense_reference` against `cell_force_pallas` in
    interpret mode (compute_force's roll arm, forced by a zero row limit)
    and against compute_force's K1 arm (`column_half_force_pallas`), at
    rtol 1e-10 / atol 1e-10*max (the sums run in another order);
  - 11-step cell-mode trajectories against JAX Simulation(list_mode="cell")
    (positions by tag atol 1e-11, etotal rel 1e-12, nbuilds equal);
  - `thermo_modify norm` set on both packages' Simulation.
Positions are jittered by a seeded +-0.05 so forces are not lattice zeros.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.ops import cellforce as jax_cellforce
from lammps_kokkos_port_tpu.ops import pallas_pair
from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch import interop
from lammps_kokkos_port_tpu_torch.ops import cellforce
from lammps_kokkos_port_tpu_torch.ops.cell_kernels import (
    lj_cell_dense,
    lj_cell_dense_reference,
)
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim

RTOL, ATOL_REL = 1e-10, 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once, and each worker's intra-op thread
    pool would otherwise claim every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[6, 7])
def jax_cell(request):
    """The JAX cell-mode sim after setup(), its state jittered, and the
    port's state, style and cell list made from them."""
    sim = jax_lj_melt_sim(cells=request.param, t_init=1.44,
                          dtype=jnp.float64, list_mode="cell")
    sim.setup()
    st = sim.state
    valid = np.asarray(st.valid_mask)
    x = np.array(st.x)
    rng = np.random.default_rng(2026 + request.param)
    x[valid] += rng.uniform(-0.05, 0.05, (int(valid.sum()), 3))
    st = st.replace(x=jnp.asarray(x))
    port_state = interop.state_from_arrays(interop.dataclass_to_arrays(st))
    style = interop.pair_from_arrays(
        interop.dataclass_to_arrays(sim.pair_style))
    cl = interop.cell_list_from_arrays(interop.dataclass_to_arrays(sim.nl))
    return sim, st, port_state, style, cl


def _close(got, ref, valid):
    """Valid rows within RTOL / ATOL_REL*max, padding rows exactly 0."""
    assert np.abs(ref[valid]).max() > 1.0  # jittered: forces are real
    np.testing.assert_allclose(got[valid], ref[valid], rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref[valid]).max())
    np.testing.assert_array_equal(got[~valid], 0.0)


def _by_tag(x, valid, tag):
    return x[valid][np.argsort(tag[valid])]


def test_build_cell_matches_jax(jax_cell):
    sim, _, _, _, cl = jax_cell
    port_state = interop.state_from_arrays(
        interop.dataclass_to_arrays(sim.state))
    mine = cellforce.build_cell(port_state, cl.params)
    got = interop.cell_list_to_arrays(mine)
    ref = interop.dataclass_to_arrays(sim.nl)
    for k in ("buckets", "stencil", "xhold", "overflow"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["params"] == ref["params"]
    assert (got["ago"], got["nbuilds"]) == (0, 1) == (int(ref["ago"]),
                                                      int(ref["nbuilds"]))
    if port_state.capacity > port_state.nlocal:
        # padded rows sit in the dead bucket row, as in the JAX package
        dead = mine.buckets[cl.params.total_cells].numpy()
        assert np.isin(np.arange(port_state.nlocal, port_state.capacity),
                       dead).all()


def test_thermo_path_matches_jax(jax_cell):
    sim, st, port_state, style, cl = jax_cell
    f_ref, pe_ref, vir_ref = jax_cellforce.compute(sim.pair_style, st,
                                                   sim.nl, True, True)
    f, pe, vir = cellforce.compute(style, port_state, cl, True, True)
    valid = np.asarray(st.valid_mask)
    _close(f.numpy(), np.asarray(f_ref), valid)
    assert pe.item() == pytest.approx(float(pe_ref), rel=RTOL)
    np.testing.assert_allclose(vir.numpy(), np.asarray(vir_ref), rtol=RTOL,
                               atol=ATOL_REL * np.abs(vir_ref).max())


@pytest.mark.parametrize("arm", ["K6", "K1"])
def test_force_pass_matches_jax(jax_cell, monkeypatch, arm):
    """The port's force-only cell pass (the K6 twin on CPU tensors)
    against both arms of JAX compute_force: K6 `cell_force_pallas` on the
    candidates its roll branch builds (row limit forced to 0) and the K1
    column kernel that small periodic grids take."""
    sim, st, port_state, style, cl = jax_cell
    if arm == "K6":
        monkeypatch.setattr(pallas_pair, "_VMEM_ROW_LIMIT", 0)
        calls = []
        k6 = pallas_pair.cell_force_pallas
        monkeypatch.setattr(pallas_pair, "cell_force_pallas",
                            lambda *a, **k: calls.append(1) or k6(*a, **k))
    f_ref = np.asarray(jax.device_get(pallas_pair.compute_force(
        sim.pair_style.kernel_key(), st, sim.nl)))
    if arm == "K6":
        assert calls  # really on the K6 arm
    launches = lj_cell_dense.launches
    f, pe, vir = cellforce.compute(style, port_state, cl, False, False)
    assert pe is None and vir is None
    assert lj_cell_dense.launches == launches  # CPU: the plain version
    f_plain = lj_cell_dense_reference(
        style.kernel_key(), cl.buckets, cl.stencil, port_state.x,
        port_state.box.prd)
    assert torch.equal(f, f_plain)
    _close(f.numpy(), f_ref, np.asarray(st.valid_mask))


def test_dead_stencil_cells_contribute_nothing(jax_cell):
    """A stencil entry equal to the cell count (across a non-periodic
    face) is skipped, though the dead bucket row may hold padded rows."""
    _, _, port_state, style, cl = jax_cell
    ntot = cl.params.total_cells
    key = style.kernel_key()
    prd = port_state.box.prd
    f = lj_cell_dense(key, cl.buckets, cl.stencil, port_state.x, prd)
    # route every (cell, 13th-entry = own cell) pair to the dead row: the
    # own-cell pairs vanish from the result
    stencil = cl.stencil.clone()
    stencil[:, 13] = ntot
    f_dead = lj_cell_dense(key, cl.buckets, stencil, port_state.x, prd)
    own_only = cl.stencil.clone()
    own_only[:, [s for s in range(27) if s != 13]] = ntot
    f_own = lj_cell_dense(key, cl.buckets, own_only, port_state.x, prd)
    torch.testing.assert_close(f_dead + f_own, f, rtol=1e-10, atol=1e-9)
    assert f_own.abs().max() > 0


@pytest.mark.parametrize("every,delay,check", [(20, 0, False),
                                               (1, 5, True)])
def test_cell_trajectory_matches_jax(every, delay, check):
    """11 steps of list mode "cell": under `every 20 check no` no rebuild
    fires; under `every 1 delay 5 check yes` at T=3 the displacement check
    fires one (and the grid grows once by the overflow retry, in both
    packages)."""
    kw = dict(cells=6, t_init=3.0, every=every, delay=delay, check=check,
              list_mode="cell")
    sim = lj_melt_sim(dtype=torch.float64, device="cpu", **kw)
    sim.setup()
    rows = sim.run(11)
    ref = jax_lj_melt_sim(dtype=jnp.float64, **kw)
    ref.setup()
    ref_rows = ref.run(11)

    assert (dataclasses.asdict(sim.nl.params)
            == dataclasses.asdict(ref.nl.params))
    assert sim.nl.nbuilds == int(ref.nl.nbuilds) == (2 if check else 1)
    st = sim.state
    x = _by_tag(st.x.numpy(), st.valid_mask.numpy(), st.tag.numpy())
    x_ref = _by_tag(np.asarray(ref.state.x), np.asarray(ref.state.valid_mask),
                    np.asarray(ref.state.tag))
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-11)
    for r, rr in zip(rows, ref_rows):
        assert r["etotal"] == pytest.approx(rr["etotal"], rel=1e-12)
        assert r["press"] == pytest.approx(rr["press"], rel=1e-10)


@pytest.mark.parametrize("norm", [False, True])
def test_thermo_modify_norm_matches_jax(norm):
    """`thermo_modify norm` set on both packages' Simulation: lj units
    normalise per atom by default; `norm no` prints totals."""
    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64,
                      device="cpu")
    sim.setup()
    ref = jax_lj_melt_sim(cells=6, t_init=1.44, dtype=jnp.float64)
    ref.setup()
    sim.thermo_norm = ref.thermo_norm = norm
    row, ref_row = sim.thermo(), ref.thermo()
    for k in ("epair", "ke", "etotal"):
        assert row[k] == pytest.approx(ref_row[k], rel=1e-12), k
    scale = 1.0 if norm else 864.0
    assert row["epair"] == pytest.approx(-6.7733681 * scale, rel=1e-7)
