"""PyTorch port, pair-force kernel: the plain twin against the TPU kernels.

`lj_cell_force` on CPU tensors runs the plain PyTorch version of the CUDA
kernel (`lj_cell_force_reference`). It must reproduce each of the three
Pallas kernels it replaces, run in interpret mode on the JAX sorted state
after setup() with positions jittered by a seeded +-0.05:
  K1 column_half_force_pallas  (default dispatch, cap <= _VMEM_ROW_LIMIT)
  K2 slab_half_force_pallas    (_VMEM_ROW_LIMIT below cap)
  K3 plane_force_pallas        (K2 dispatch with plane_half_fits False)
Tolerance: rtol 1e-9 / atol 1e-10 on valid rows, as tests/test_slab_half.py
(the summation order differs between the Newton-halved and full stencils).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.ops import pallas_pair
from lammps_kokkos_port_tpu.ops import sortedforce as jax_sortedforce
from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import (
    lj_cell_force,
    lj_cell_force_reference,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once, and each worker's intra-op thread
    pool would otherwise claim every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kernel,cells,limit", [
    ("K1", 6, None),
    ("K2", 8, 1),
    ("K2", 12, 10000),
    ("K3", 6, 1),
])
def test_plain_twin_matches_tpu_kernel(monkeypatch, kernel, cells, limit):
    if limit is not None:
        monkeypatch.setattr(pallas_pair, "_VMEM_ROW_LIMIT", limit)
    if kernel == "K3":
        monkeypatch.setattr(pallas_pair, "plane_half_fits", lambda p: False)
    sim = jax_lj_melt_sim(cells=cells, t_init=1.44, dtype=jnp.float64,
                          every=20, delay=0, check=False, list_mode="sorted")
    sim.setup()
    st, nl = sim.state, sim.nl
    p = nl.params
    if limit is not None:
        assert st.capacity > limit  # really on the slab/plane dispatch arm

    valid = np.asarray(st.valid_mask)
    x = np.array(st.x)
    rng = np.random.default_rng(2024 + cells)
    x[valid] += rng.uniform(-0.05, 0.05, (int(valid.sum()), 3))
    st = st.replace(x=jnp.asarray(x))
    f_ref = np.asarray(jax.device_get(jax_sortedforce.compute(
        sim.pair_style, st, nl, False, False)[0]))

    key = sim.pair_style.kernel_key()
    g = torch.from_numpy(x).t().contiguous().reshape(3, p.total_cells,
                                                     p.cell_cap)
    prd = torch.from_numpy(np.array(st.box.prd))
    launches = lj_cell_force.launches
    f = lj_cell_force(key, p.ncells, g[0], g[1], g[2], prd)
    assert lj_cell_force.launches == launches  # CPU: the plain version
    f_plain = lj_cell_force_reference(key, p.ncells, g[0], g[1], g[2], prd)
    assert torch.equal(f, f_plain)
    f = f.reshape(3, -1).t().numpy()
    assert np.abs(f_ref[valid]).max() > 1.0  # jittered: forces are real
    np.testing.assert_allclose(f[valid], f_ref[valid], rtol=1e-9, atol=1e-10)
    np.testing.assert_array_equal(f[~valid], 0.0)


def test_degenerate_grid_raises():
    key = ("lj", 48.0, 24.0, 6.25)
    g = torch.zeros(2 * 3 * 3, 8, dtype=torch.float64)
    prd = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match=">= 3 cells"):
        lj_cell_force(key, (2, 3, 3), g, g, g, prd)
