"""PyTorch port, K7: the plain twin of the full-stencil column kernel
against the TPU kernel `column_force_pallas` (interpret mode on the CPU).

The inputs are the JAX sorted state of the 864-atom melt after setup()
(grid (3, 3, 3) x cc 32), f64, positions jittered by a seeded +-0.05, with
the float ids the profiling script builds (`where(valid, row, -1)`), and
with scrambled ids (duplicates, -1 on real rows), since K7 masks by id
only. Tolerance: rtol 1e-10 with atol 1e-10*max|f| on every row: the sums
run in another order; the cutoff decisions agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.ops import pallas_pair
from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch.ops.column_kernels import (
    lj_column_force,
    lj_column_force_reference,
)
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import lj_cell_force


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid():
    sim = jax_lj_melt_sim(cells=6, t_init=1.44, dtype=jnp.float64, every=20,
                          delay=0, check=False)
    sim.setup()
    st, p = sim.state, sim.nl.params
    valid = np.asarray(st.valid_mask)
    x = np.array(st.x)
    rng = np.random.default_rng(7)
    x[valid] += rng.uniform(-0.05, 0.05, (int(valid.sum()), 3))
    cap = st.capacity
    ids = np.where(valid, np.arange(cap), -1).astype(np.float64)
    return dict(key=sim.pair_style.kernel_key(), ncells=tuple(p.ncells),
                cc=p.cell_cap, x=x, ids=ids, valid=valid,
                prd=np.array(st.box.prd))


def _both(g, ncells, ids):
    """K7 in JAX and the port's twin on one set of column channels."""
    nx, ny, nz = ncells
    shape = (nx * ny, nz, g["cc"])
    cols = [np.ascontiguousarray(g["x"][:, d].reshape(shape))
            for d in range(3)] + [ids.reshape(shape)]
    ref = pallas_pair.column_force_pallas(
        g["key"], ncells, *(jnp.asarray(a) for a in cols),
        jnp.asarray(g["prd"]))
    args = [torch.from_numpy(a.copy()) for a in cols]
    got = lj_column_force_reference(g["key"], ncells, *args,
                                    torch.from_numpy(g["prd"]))
    return [np.asarray(a) for a in ref], [a.numpy() for a in got], args


def _assert_close(got, ref):
    fmax = max(np.abs(a).max() for a in ref)
    assert fmax > 1.0  # jittered: the forces are real
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * fmax)


@pytest.mark.parametrize("ids", ["sorted", "scrambled"])
def test_twin_matches_column_force_pallas(grid, ids):
    gi = grid["ids"]
    if ids == "scrambled":
        gi = np.random.default_rng(3).integers(-1, 40, gi.shape).astype(
            np.float64)
    ref, got, args = _both(grid, grid["ncells"], gi)
    _assert_close(got, ref)
    # the CPU wrapper runs the twin and launches nothing
    launches = lj_column_force.launches
    wrapped = lj_column_force(grid["key"], grid["ncells"], *args,
                              torch.from_numpy(grid["prd"]))
    assert lj_column_force.launches == launches
    assert all(torch.equal(a, torch.from_numpy(b))
               for a, b in zip(wrapped, got))


def test_small_grid_matches_column_force_pallas(grid):
    """The same 27 x 32 rows read as a (1, 3, 9) grid: a dim of one cell
    sees its own column three times, shifted by -prd, 0 and +prd."""
    ref, got, _ = _both(grid, (1, 3, 9), grid["ids"])
    _assert_close(got, ref)


def test_twin_matches_the_lj_kernel_on_real_rows(grid):
    """With well-formed ids K7 computes the forces of the port's lj kernel
    (self pair by id there, by lane here)."""
    _, got, args = _both(grid, grid["ncells"], grid["ids"])
    cc = grid["cc"]
    f1 = lj_cell_force(grid["key"], grid["ncells"],
                       *(a.reshape(-1, cc) for a in args[:3]),
                       torch.from_numpy(grid["prd"]))
    for d in range(3):
        np.testing.assert_allclose(got[d].reshape(-1), f1[d].reshape(-1),
                                   rtol=1e-10, atol=1e-10)


def test_bad_shapes_raise():
    key = ("lj", 48.0, 24.0, 6.25)
    g = torch.zeros(9, 3, 8, dtype=torch.float64)
    prd = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="column channels"):
        lj_column_force(key, (3, 3, 4), g, g, g, g, prd)
    with pytest.raises(ValueError, match="prd"):
        lj_column_force(key, (3, 3, 3), g, g, g, g, prd.float())
