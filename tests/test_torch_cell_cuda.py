"""PyTorch port, the CUDA kernel of list mode "cell" (K6's port,
csrc/lj_cell_dense.cu) against its plain twin.

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). The
kernel is built from the repository's source at first use. Run it on the
card with:

    python -m pytest --noconftest -m cuda tests/test_torch_cell_cuda.py

(`--noconftest`: the suite's conftest configures jax, which this file does
not use.) Tolerances: f64 rtol 1e-10 with atol 1e-10*max|f|; f32 rtol 1e-4
with atol 1e-4*max|f|. The kernel rounds the minimum image and r2 as the
twin does, so both make the same cutoff decisions; only the order of the
force sums differs.
"""

import pytest
import torch

from lammps_kokkos_port_tpu_torch.ops import cell_kernels, cellforce
from lammps_kokkos_port_tpu_torch.ops.cell_kernels import (
    lj_cell_dense,
    lj_cell_dense_reference,
)
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cell_sim(device, dtype, cells=6):
    sim = lj_melt_sim(cells=cells, t_init=1.44, dtype=dtype, device=device,
                      list_mode="cell")
    sim.setup()
    return sim


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain(cuda, dtype, monkeypatch):
    sim = _cell_sim(cuda, dtype)
    st, cl = sim.state, sim.nl
    gen = torch.Generator(device=cuda).manual_seed(6)
    jitter = (torch.rand(st.x.shape, generator=gen, device=cuda,
                         dtype=dtype) - 0.5) * 0.1
    x = torch.where(st.valid_mask[:, None], st.x + jitter, st.x)
    key = sim.pair_style.kernel_key()
    prd = st.box.prd.to(dtype)
    ref = lj_cell_dense_reference(key, cl.buckets, cl.stencil, x, prd)

    # a CUDA tensor launches the kernel, never the plain version
    def no_plain(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(cell_kernels, "lj_cell_dense_reference", no_plain)
    before = lj_cell_dense.launches
    f = lj_cell_dense(key, cl.buckets, cl.stencil, x, prd)
    torch.cuda.synchronize()
    assert lj_cell_dense.launches == before + 1
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    amax = ref.abs().max().item()
    assert amax > 1.0  # jittered: the forces are not lattice zeros
    torch.testing.assert_close(f, ref, rtol=tol, atol=tol * amax)
    valid = st.valid_mask
    assert torch.equal(f[~valid], torch.zeros_like(f[~valid]))


def test_force_pass_launches_kernel(cuda):
    """cellforce.compute's force-only pass on the card is one launch."""
    sim = _cell_sim(cuda, torch.float32)
    before = lj_cell_dense.launches
    f, pe, vir = cellforce.compute(sim.pair_style, sim.state, sim.nl, False,
                                   False)
    torch.cuda.synchronize()
    assert lj_cell_dense.launches == before + 1
    assert pe is None and vir is None and bool(torch.isfinite(f).all())


def test_cell_run_card_matches_cpu(cuda):
    """10 steps of list mode "cell" in f64, on the card (kernel) and on the
    CPU (plain version): thermo at rel 1e-10; one launch per force step."""
    rows = {}
    for dev in (cuda, torch.device("cpu")):
        sim = _cell_sim(dev, torch.float64)
        params, before = sim.nl.params, lj_cell_dense.launches
        rows[dev.type] = sim.run(10, thermo_every=5)
        if dev.type == "cuda":
            # an overflow retry (the grid grew) re-runs a segment's steps
            n = lj_cell_dense.launches - before
            assert n == 10 or (n > 10 and sim.nl.params != params)
    for a, b in zip(rows["cuda"], rows["cpu"]):
        for k in ("temp", "epair", "etotal", "press"):
            assert a[k] == pytest.approx(b[k], rel=1e-10), (a["step"], k)


def test_kernel_rejects_bad_input(cuda):
    sim = _cell_sim(cuda, torch.float32)
    cl, x = sim.nl, sim.state.x
    key = sim.pair_style.kernel_key()
    prd = sim.state.box.prd.float()
    with pytest.raises(ValueError, match="prd"):
        lj_cell_dense(key, cl.buckets, cl.stencil, x, prd.double())
    with pytest.raises(ValueError, match="contiguous"):
        lj_cell_dense(key, cl.buckets, cl.stencil.t().contiguous().t(), x,
                      prd)
    with pytest.raises(ValueError, match="stencil"):
        lj_cell_dense(key, cl.buckets, cl.stencil[:-1], x, prd)
