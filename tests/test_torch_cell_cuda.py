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
force sums differs. The planted pairs at r2 = cutsq and one ulp either side
of it show the decisions are the same bit for bit.
"""

import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu_torch.ops import cell_kernels, cellforce
from lammps_kokkos_port_tpu_torch.ops.cell_kernels import (
    lj_cell_dense,
    lj_cell_dense_reference,
)
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
from test_torch_pair_kernel_cuda import KEY, boundary_targets, planted_pairs

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


def _stencil(ncells):
    """[ncell, 27] periodic neighbour cell ids, cellforce's order."""
    nx, ny, nz = ncells
    out = []
    for c in range(nx * ny * nz):
        cx, cy, cz = c // (ny * nz), (c // nz) % ny, c % nz
        out.append([(((cx + i) % nx) * ny + (cy + j) % ny) * nz + (cz + k) % nz
                    for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1)])
    return torch.tensor(out, dtype=torch.int32)


def _buckets(cells_of, ncell, cc, rng):
    """[ncell+1, cc] buckets, each atom at a lane drawn at random in its
    cell (empty lanes, == cap, interleaved: not packed)."""
    cap = len(cells_of)
    b = np.full((ncell + 1, cc), cap, dtype=np.int32)
    for c in range(ncell):
        atoms = np.flatnonzero(cells_of == c)
        b[c, rng.choice(cc, len(atoms), replace=False)] = atoms
    return torch.from_numpy(b)


def _launch_and_check(key, buckets, stencil, x, prd, dtype):
    ref = lj_cell_dense_reference(key, buckets, stencil, x, prd)
    before = lj_cell_dense.launches
    f = lj_cell_dense(key, buckets, stencil, x, prd)
    torch.cuda.synchronize()
    assert lj_cell_dense.launches == before + 1
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    amax = ref.abs().max().item()
    torch.testing.assert_close(f, ref, rtol=tol, atol=tol * max(amax, 1e-30))
    return f, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_full_cell_unpacked(cuda, dtype):
    """cc 36 with one cell of 36 atoms (its rows 32-35 run in the warp's
    second row pass) and buckets that are not packed; the rest hold 8-27
    atoms on jittered sub-lattices."""
    rng = np.random.default_rng(36)
    ncells, side, cc = (3, 4, 3), 3.0, 36
    nx, ny, nz = ncells
    pos, cells_of = [], []
    for c in range(nx * ny * nz):
        n = 36 if c == 4 else 8 + (c * 5) % 20
        m = 3 if n <= 27 else 4
        sub = np.stack(np.meshgrid(np.arange(m), np.arange(3), np.arange(3),
                                   indexing="ij"), -1).reshape(-1, 3)[:n]
        origin = np.array([c // (ny * nz), (c // nz) % ny, c % nz]) * side
        pos.append(origin + (sub + 0.5) / [m, 3, 3] * side
                   + rng.uniform(-0.05, 0.05, (n, 3)))
        cells_of += [c] * n
    x = torch.from_numpy(np.concatenate(pos)).to(dtype).to(cuda)
    buckets = _buckets(np.array(cells_of), nx * ny * nz, cc, rng).to(cuda)
    prd = torch.tensor([nx * side, ny * side, nz * side], dtype=dtype,
                       device=cuda)
    stencil = _stencil(ncells).to(cuda)
    f, ref = _launch_and_check(KEY, buckets, stencil, x, prd, dtype)
    assert ref.abs().max().item() > 1.0
    assert bool((f[np.array(cells_of) == 4].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cutoff_boundary_pairs(cuda, dtype):
    """Pairs planted at r2 = cutsq, one ulp below and one ulp above it: only
    the pair below is inside the cutoff, in the kernel as in the plain
    version (the minimum image leaves these displacements as they are)."""
    pos = planted_pairs(dtype, boundary_targets(dtype))
    ncells, side, cc = (8, 3, 3), 3.0, 36
    cells = (pos // side).astype(int)
    cells_of = (cells[:, 0] * 3 + cells[:, 1]) * 3 + cells[:, 2]
    rng = np.random.default_rng(7)
    buckets = _buckets(cells_of, 72, cc, rng).to(cuda)
    x = torch.from_numpy(pos).to(dtype).to(cuda)
    prd = torch.tensor([24.0, 9.0, 9.0], dtype=dtype, device=cuda)
    f, ref = _launch_and_check(KEY, buckets, _stencil(ncells).to(cuda), x,
                               prd, dtype)
    inside = ref.abs().sum(-1) > 0
    assert inside.tolist() == [False, False, True, True, False, False]
    assert torch.equal(f.abs().sum(-1) > 0, inside)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_atoms_at_box_faces(cuda, dtype):
    """Atoms on and just across the periodic faces (drifted out of the box
    since their binning, as between rebuilds), so pairs meet through the
    minimum image: the kernel's candidate pruning under the minimum image
    keeps every pair the plain version takes."""
    rng = np.random.default_rng(9)
    side, n = 3.0, 3
    prd_v = n * side
    faces = np.array([0.0, 1e-6, -0.12, prd_v - 1e-6, prd_v - 0.04,
                      prd_v + 0.1, 0.3, prd_v - 0.3])
    pos = rng.uniform(0.0, prd_v, (300, 3))
    for a in range(3):  # a third of the atoms on a face of each axis
        sel = rng.choice(300, 100, replace=False)
        pos[sel, a] = rng.choice(faces, 100)
    # drop near-coincident atoms: keep the forces finite in f32
    keep = []
    for i, p in enumerate(pos):
        d = pos[keep] - p
        d -= prd_v * np.round(d / prd_v)
        if not keep or (d * d).sum(-1).min() > 0.6 ** 2:
            keep.append(i)
    pos = pos[keep]
    cell = np.clip(np.floor(np.clip(pos, 0, prd_v - 1e-9) / side), 0,
                   n - 1).astype(int)
    cells_of = (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]
    cc = int(np.bincount(cells_of, minlength=27).max())
    buckets = _buckets(cells_of, 27, cc, rng).to(cuda)
    x = torch.from_numpy(pos).to(dtype).to(cuda)
    prd = torch.full((3,), prd_v, dtype=dtype, device=cuda)
    f, ref = _launch_and_check(KEY, buckets, _stencil((n, n, n)).to(cuda), x,
                               prd, dtype)
    assert ref.abs().max().item() > 1.0
    assert torch.equal(f.abs().sum(-1) > 0, ref.abs().sum(-1) > 0)


def test_launch_shape(cuda):
    """One warp per cell, four cells a block, within the default 48 KB of
    shared memory."""
    for dtype in (torch.float32, torch.float64):
        big = cell_kernels.launch_shape(47 * 23 * 47, dtype)
        assert big["threads"] == (32, 4)
        assert big["blocks"] == -(-47 * 23 * 47 // 4)
        assert 0 < big["smem_bytes"] <= 48 * 1024
