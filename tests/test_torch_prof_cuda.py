"""PyTorch port, the four CUDA kernels of the profiling paths against their
plain twins: K7 (csrc/lj_column_full.cu), K8 and P10
(csrc/lj_plane_half.cu), P9 (csrc/lj_ablate.cu).

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). The
kernels are built from the repository's sources at first use. Run on the
card with:

    python -m pytest --noconftest -m cuda tests/test_torch_prof_cuda.py

(`--noconftest`: the suite's conftest configures jax, which this file does
not use.) Inputs: the sorted state of the 864-atom melt, positions
jittered by a seeded +-0.05. Tolerances: f64 rtol 1e-10, f32 rtol 1e-4,
each with atol rtol*max|f|: kernel and twin make the same cutoff decisions
(r2 rounded alike) and sum in other orders; K8's reactions are summed by
shared-memory atomics, in an order that changes from run to run. P9's
approximate reciprocal (rcp.approx.ftz.f32, at most 1 ulp off) is held to
the exact twin within the same f32 tolerance.
"""

import pytest
import torch

from lammps_kokkos_port_tpu_torch.ops import column_kernels, half_kernels
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import lj_cell_force
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
from lammps_kokkos_port_tpu_torch.prof import ablate_kernels as ak
from lammps_kokkos_port_tpu_torch.prof.grid import sorted_planes

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(device, dtype):
    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=dtype, device=device)
    sim.setup()
    st = sim.state
    gen = torch.Generator(device=device).manual_seed(6)
    jitter = (torch.rand(st.x.shape, generator=gen, device=device,
                         dtype=dtype) - 0.5) * 0.1
    return sorted_planes(sim, torch.where(st.valid_mask[:, None],
                                          st.x + jitter, st.x))


def _assert_close(got, ref, dtype):
    rtol = 1e-10 if dtype == torch.float64 else 1e-4
    vmax = max(a.abs().max().item() for a in ref)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=rtol, atol=rtol * vmax)


def _no_plain(monkeypatch, module, name):
    def plain(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(module, name, plain)


@pytest.mark.parametrize("dtype", DTYPES)
def test_column_kernel_matches_twin(cuda, dtype, monkeypatch):
    sp = _planes(cuda, dtype)
    args = (sp.key, sp.ncells, *sp.col, sp.prd)
    ref = column_kernels.lj_column_force_reference(*args)
    _no_plain(monkeypatch, column_kernels, "lj_column_force_reference")
    before = column_kernels.lj_column_force.launches
    got = column_kernels.lj_column_force(*args)
    torch.cuda.synchronize()
    assert column_kernels.lj_column_force.launches == before + 1
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["lj_plane_half_force", "lj_plane_half_fwd"])
def test_plane_half_kernels_match_twins(cuda, dtype, name, monkeypatch):
    sp = _planes(cuda, dtype)
    args = (sp.key, sp.ncells, sp.cap, *sp.plane, sp.prd)
    plain = name + "_reference"
    ref = getattr(half_kernels, plain)(*args)
    _no_plain(monkeypatch, half_kernels, plain)
    fn = getattr(half_kernels, name)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plane_half_equals_full_stencil(cuda, dtype):
    """Newton-half with reactions and the full stencil: the same forces."""
    sp = _planes(cuda, dtype)
    f8 = half_kernels.lj_plane_half_force(sp.key, sp.ncells, sp.cap,
                                          *sp.plane, sp.prd)
    f1 = lj_cell_force(sp.key, sp.ncells, *sp.flat[:3], sp.prd)
    _assert_close([a.reshape(-1) for a in f8],
                  [a.reshape(-1) for a in f1], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ablation_kernels_match_twins(cuda, dtype):
    sp = _planes(cuda, dtype)
    gx, gy, gz, gi = sp.col
    got = ak.asm_only(sp.ncells, gx, gy, gz, gi, sp.prd)
    ref = ak.asm_only_reference(sp.ncells, gx, gy, gz, gi, sp.prd)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # live pair math: positions 3 +- [0.8, 1.6] per axis, ids -1..2
    gen = torch.Generator(device=cuda).manual_seed(9)

    def near3(a):
        u = torch.rand(a.shape, generator=gen, device=cuda, dtype=dtype)
        return 3.0 + torch.where(u < 0.5, -1.0, 1.0) * (0.8 + 0.8 * u)

    live = [near3(a) for a in (gx, gy, gz)]
    ids = torch.remainder(torch.arange(gi.numel(), device=cuda),
                          4).to(dtype).reshape(gi.shape) - 1
    variants = [ak.pair_only] + ([ak.pair_only_approx]
                                 if dtype == torch.float32 else [])
    ref = ak.pair_only_reference(sp.key, sp.ncells, *live, ids, sp.prd)
    assert ref[0].abs().max() > 1.0
    for fn in variants:
        before = fn.launches
        got = fn(sp.key, sp.ncells, *live, ids, sp.prd)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _assert_close(got, ref, dtype)
    if dtype == torch.float64:
        with pytest.raises(TypeError, match="float32"):
            ak.pair_only_approx(sp.key, sp.ncells, *live, ids, sp.prd)
