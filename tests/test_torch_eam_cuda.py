"""PyTorch port, the two CUDA EAM sweeps against their plain twins.

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). The
kernels are built from the repository's source at first use. Run it on
the card with:

    python -m pytest --noconftest -m cuda tests/test_torch_eam_cuda.py

(`--noconftest`: the suite's conftest configures jax, which this file does
not use.) Inputs: the sorted state of the bench/in.eam deck at cells 6
after setup(), on the synthetic Sutton-Chen stand-in potential, positions
jittered by a seeded +-0.08 A. Tolerances: f64 rtol 1e-10 with atol
1e-10*max|value|; f32 rtol 1e-4 with atol 1e-4*max|value|. Kernel and twin
make the same cutoff decisions (r2 is rounded alike); the Chebyshev series
and the sums differ in rounding and order.
"""

import pytest
import torch

from lammps_kokkos_port_tpu_torch.io.eam_reader import (
    write_sutton_chen_funcfl,
)
from lammps_kokkos_port_tpu_torch.ops import eam_kernels
from lammps_kokkos_port_tpu_torch.ops.eamdense import embedding_fp
from lammps_kokkos_port_tpu_torch.presets import eam_bulk_cu_sim

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sim(tmp_path, dtype, device, cells=6):
    pot = write_sutton_chen_funcfl(tmp_path / "sc.eam")
    sim = eam_bulk_cu_sim(cells=cells, dtype=dtype, device=device,
                          potential_path=pot, list_mode="sorted")
    sim.setup()
    return sim


def _grid_inputs(sim, dtype):
    st, p = sim.state, sim.nl.params
    gen = torch.Generator(device=st.device).manual_seed(6)
    jitter = (torch.rand(st.x.shape, generator=gen, device=st.device,
                         dtype=torch.float64) - 0.5) * 0.16
    x = torch.where(st.valid_mask[:, None], st.x.double() + jitter,
                    st.x.double()).to(dtype)
    g = x.t().contiguous().reshape(3, p.total_cells, p.cell_cap)
    tabs = sim.pair_style.poly_tables
    cutsq = float(sim.pair_style.cutmax) ** 2
    return (g, st.box.prd.to(dtype), eam_kernels.rho_tab(tabs, cutsq),
            eam_kernels.force_tab(tabs, cutsq), tabs)


def _assert_close(got, ref, dtype):
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(got, ref, rtol=tol,
                               atol=tol * ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain(cuda, tmp_path, dtype):
    sim = _sim(tmp_path, dtype, cuda)
    p = sim.nl.params
    g, prd, rtab, ftab, tabs = _grid_inputs(sim, dtype)

    before = eam_kernels.eam_cell_rho.launches
    rho = eam_kernels.eam_cell_rho(rtab, p.ncells, g[0], g[1], g[2], prd)
    torch.cuda.synchronize()
    assert eam_kernels.eam_cell_rho.launches == before + 1
    rho_ref = eam_kernels.eam_cell_rho_reference(rtab, p.ncells, g[0], g[1],
                                                 g[2], prd)
    _assert_close(rho, rho_ref, dtype)

    fp = embedding_fp(tabs, rho_ref.reshape(-1), sim.state.valid_mask)
    gfp = fp.to(dtype).reshape(p.total_cells, p.cell_cap)
    before = eam_kernels.eam_cell_force.launches
    f = eam_kernels.eam_cell_force(ftab, p.ncells, g[0], g[1], g[2], gfp, prd)
    torch.cuda.synchronize()
    assert eam_kernels.eam_cell_force.launches == before + 1
    f_ref = eam_kernels.eam_cell_force_reference(ftab, p.ncells, g[0], g[1],
                                                 g[2], gfp, prd)
    _assert_close(f, f_ref, dtype)


def test_run_on_card_matches_cpu(cuda, tmp_path):
    """The slice on the card (kernels) against the same slice on the CPU
    (plain twins), f64, 10 steps with a rebuild."""
    rows = {}
    for dev in (cuda, torch.device("cpu")):
        sim = _sim(tmp_path, torch.float64, dev)
        before = (eam_kernels.eam_cell_rho.launches,
                  eam_kernels.eam_cell_force.launches)
        rows[dev.type] = sim.run(10, thermo_every=10)
        n_rho, n_force = (eam_kernels.eam_cell_rho.launches - before[0],
                          eam_kernels.eam_cell_force.launches - before[1])
        if dev.type == "cuda":
            # one of each per force step; a capacity overflow (this small
            # box grows its cell_cap) re-runs the segment's steps
            assert n_rho == n_force and n_rho % 10 == 0 and n_rho >= 10
        else:
            assert n_rho == n_force == 0  # CPU: the plain versions
        assert sim.nl.nbuilds > 1
    for a, b in zip(rows["cuda"], rows["cpu"]):
        for k in ("temp", "pe", "etotal", "press"):
            assert a[k] == pytest.approx(b[k], rel=1e-10), k


def test_kernels_reject_bad_input(cuda, tmp_path):
    sim = _sim(tmp_path, torch.float32, cuda)
    p = sim.nl.params
    g, prd, rtab, ftab, _ = _grid_inputs(sim, torch.float32)
    strided = torch.zeros(p.total_cells, p.cell_cap, 2, device=cuda)[..., 0]
    with pytest.raises(ValueError, match="contiguous"):
        eam_kernels.eam_cell_rho(rtab, p.ncells, strided, g[1], g[2], prd)
    with pytest.raises(ValueError, match="prd"):
        eam_kernels.eam_cell_rho(rtab, p.ncells, g[0], g[1], g[2],
                                 prd.double())
    with pytest.raises(ValueError, match="coefficients"):
        eam_kernels.eam_cell_rho((rtab[0][:-1],) + rtab[1:], p.ncells, g[0],
                                 g[1], g[2], prd)
    with pytest.raises(ValueError, match="channels"):
        eam_kernels.eam_cell_force(ftab, p.ncells, g[0], g[1], g[2],
                                   g[0].double(), prd)
