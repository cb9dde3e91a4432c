"""PyTorch port, the CUDA pair-force kernel against its plain twin.

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). The
kernel is built from the repository's source at first use. Run it on the
card with:

    python -m pytest --noconftest -m cuda tests/test_torch_pair_kernel_cuda.py

(`--noconftest`: the suite's conftest configures jax, which this file does
not use.) Tolerances: f64 rtol 1e-10; f32 rtol 1e-4 with atol 1e-4*max|f|.
The kernel and the plain version make the same cutoff decisions (r2 is
computed without fused multiply-adds in both); only the order of the force
sums differs.
"""

import pytest
import torch

from lammps_kokkos_port_tpu_torch.ops.pair_kernels import (
    lj_cell_force,
    lj_cell_force_reference,
)
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain(cuda, dtype):
    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=dtype, device=cuda)
    sim.setup()
    st, p = sim.state, sim.nl.params
    gen = torch.Generator(device=cuda).manual_seed(6)
    jitter = (torch.rand(st.x.shape, generator=gen, device=cuda,
                         dtype=dtype) - 0.5) * 0.1
    x = torch.where(st.valid_mask[:, None], st.x + jitter, st.x)
    g = x.t().contiguous().reshape(3, p.total_cells, p.cell_cap)
    key = sim.pair_style.kernel_key()
    prd = st.box.prd

    before = lj_cell_force.launches
    f = lj_cell_force(key, p.ncells, g[0], g[1], g[2], prd)
    torch.cuda.synchronize()
    assert lj_cell_force.launches == before + 1
    ref = lj_cell_force_reference(key, p.ncells, g[0], g[1], g[2], prd)
    if dtype == torch.float64:
        torch.testing.assert_close(f, ref, rtol=1e-10, atol=1e-12)
    else:
        amax = ref.abs().max().item()
        torch.testing.assert_close(f, ref, rtol=1e-4, atol=1e-4 * amax)


def test_kernel_rejects_bad_input(cuda):
    key = ("lj", 48.0, 24.0, 6.25)
    g = torch.zeros(27, 8, 2, device=cuda)[..., 0]  # non-contiguous
    prd = torch.ones(3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lj_cell_force(key, (3, 3, 3), g, g, g, prd)
    with pytest.raises(ValueError, match="prd"):
        lj_cell_force(key, (3, 3, 3), g.contiguous(), g.contiguous(),
                      g.contiguous(), prd.double())
