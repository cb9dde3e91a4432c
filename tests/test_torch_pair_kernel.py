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

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.ops import pallas_pair
from lammps_kokkos_port_tpu.ops import sortedforce as jax_sortedforce
from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import (
    SOURCE,
    check_pad_cutoff,
    lj_cell_force,
    lj_cell_force_reference,
)
from lammps_kokkos_port_tpu_torch.ops.sortedforce import (
    PAD_POS,
    PAD_STEP,
    _pad_x,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pad_cutoff_raises(dtype):
    """The CUDA kernel skips pad rows on the grounds that no two pads share
    a cutoff (in an unshifted axis they differ by a multiple of PAD_STEP):
    `check_pad_cutoff`, which the wrapper runs before a launch, refuses a
    cutoff of PAD_STEP or more. The plain version skips nothing, so on the
    CPU the wrapper takes any cutoff; on the all-pad grid it finds no pair
    and no force on either side of the bound."""
    with pytest.raises(ValueError, match="pad spacing"):
        check_pad_cutoff(PAD_STEP ** 2)
    check_pad_cutoff(0.999 * PAD_STEP ** 2)
    g = _pad_x(27 * 8, dtype, "cpu").reshape(27, 8)
    prd = torch.full((3,), 9.0, dtype=dtype)
    for cutsq in (0.999 * PAD_STEP ** 2, PAD_STEP ** 2):
        f = lj_cell_force(("lj", 48.0, 24.0, cutsq), (3, 3, 3), g, g, g, prd)
        assert torch.equal(f, torch.zeros_like(f))


def test_kernel_pad_constants_match_layout():
    """The CUDA kernels' copy of the sorted layout's pad sentinel (kPadPos,
    kPadStep in csrc/sorted_grid.cuh, which lj_cell_force.cu includes)
    equals ops/sortedforce's."""
    assert '#include "sorted_grid.cuh"' in SOURCE.read_text()
    header = SOURCE.parent / "sorted_grid.cuh"
    consts = dict(re.findall(r"constexpr double (kPad\w+) = ([0-9.e+]+);",
                             header.read_text()))
    assert float(consts["kPadPos"]) == PAD_POS
    assert float(consts["kPadStep"]) == PAD_STEP


def test_pads_anywhere_in_a_cell():
    """The CUDA kernel skips pad rows wherever they sit in a cell: the
    plain version on the same rows permuted within each cell (pads before
    live rows) gives each atom the same force and every pad zero."""
    sim_x, key, ncells, prd = _sorted_melt_with_pads()
    g = torch.from_numpy(sim_x).t().contiguous().reshape(3, -1, 48)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(48))
    f = lj_cell_force(key, ncells, g[0], g[1], g[2], prd)
    gp = g[:, :, perm].contiguous()
    fp = lj_cell_force(key, ncells, gp[0], gp[1], gp[2], prd)
    torch.testing.assert_close(fp, f[:, :, perm], rtol=1e-12, atol=1e-12)
    pad = gp[0] >= 0.5 * PAD_POS
    assert bool(pad[:, :8].any()) and int(pad.sum()) == 27 * 48 - 864
    assert torch.equal(fp[:, pad], torch.zeros_like(fp[:, pad]))


def _sorted_melt_with_pads():
    """The 6-cell f64 melt re-sorted at cell_cap 48 (pads at the end of
    each cell), positions jittered by a seeded +-0.05."""
    from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
    from lammps_kokkos_port_tpu_torch.prof.grid import resort

    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64,
                      device="cpu")
    sim.setup()
    st, p = resort(sim, 48)
    x = st.x.numpy().copy()
    valid = st.valid_mask.numpy()
    rng = np.random.default_rng(48)
    x[valid] += rng.uniform(-0.05, 0.05, (int(valid.sum()), 3))
    return x, sim.pair_style.kernel_key(), p.ncells, st.box.prd
