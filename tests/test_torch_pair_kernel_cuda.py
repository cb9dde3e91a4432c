"""PyTorch port, the CUDA pair-force kernel against its plain twin.

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). The
kernel is built from the repository's source at first use. Run it on the
card with:

    python -m pytest --noconftest -m cuda tests/test_torch_pair_kernel_cuda.py

(`--noconftest`: the suite's conftest configures jax, which this file does
not use.) Tolerances: f64 rtol 1e-10; f32 rtol 1e-4 with atol 1e-4*max|f|.
The kernel and the plain version make the same cutoff decisions (r2 is
computed without fused multiply-adds in both); only the order of the force
sums differs. The planted pairs at r2 = cutsq and one ulp either side of it
show the decisions are the same bit for bit, and those planted across each
wrapped face (prof/planted.wrapped_pairs) that both rows of a pair take
the Newton-half K1's one decision (ROADMAP F12).
"""

import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu_torch.ops import pair_kernels
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import (
    lj_cell_force,
    lj_cell_force_reference,
)
from lammps_kokkos_port_tpu_torch.ops.sortedforce import (
    PAD_POS,
    PAD_STEP,
    _pad_x,
)
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
from lammps_kokkos_port_tpu_torch.prof import planted

pytestmark = pytest.mark.cuda

KEY = ("lj", 48.0, 24.0, 6.25)  # lj/cut 2.5, epsilon = sigma = 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_matches(f, ref, dtype):
    if dtype == torch.float64:
        torch.testing.assert_close(f, ref, rtol=1e-10, atol=1e-12)
    else:
        amax = ref.abs().max().item()
        torch.testing.assert_close(f, ref, rtol=1e-4, atol=1e-4 * amax)


def _launch_and_check(key, ncells, g, prd, dtype):
    before = lj_cell_force.launches
    f = lj_cell_force(key, ncells, g[0], g[1], g[2], prd)
    torch.cuda.synchronize()
    assert lj_cell_force.launches == before + 1
    ref = lj_cell_force_reference(key, ncells, g[0], g[1], g[2], prd)
    _assert_matches(f, ref, dtype)
    return f, ref


# jittered atoms at random lanes among pads: (g [3, ncell, cc], prd,
# valid [ncell, cc])
_lattice_grid = planted.lattice_grid


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
    _launch_and_check(sim.pair_style.kernel_key(), p.ncells, g,
                      st.box.prd, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cc,ncells", [(32, (3, 4, 5)), (64, (3, 3, 4))])
def test_interleaved_pads(cuda, dtype, cc, ncells):
    """Pads before live rows (the kernel packs each tile's live rows, never
    assumes packing); at cc 64 a cell holds 40 atoms, so its rows run in
    two passes of one warp."""
    ncell = ncells[0] * ncells[1] * ncells[2]
    counts = [(c * 7) % (cc // 2) + 4 for c in range(ncell)]
    if cc == 64:
        counts[5] = 40
    g, prd, valid = _lattice_grid(ncells, cc, counts, 11, dtype, cuda)
    f, ref = _launch_and_check(KEY, ncells, g, prd, dtype)
    assert ref[:, valid].abs().max().item() > 1.0
    assert torch.equal(f[:, ~valid], torch.zeros_like(f[:, ~valid]))


def _huge_box(cuda):
    """max(prd) >= PAD_POS / 4: pads cannot be told by position."""
    g, _, _ = _lattice_grid((3, 3, 3), 32, [5] * 27, 3, torch.float64, cuda)
    prd = torch.full((3,), PAD_POS / 4, dtype=torch.float64, device=cuda)
    return g, prd


def _corner_pads(cuda):
    """The pads of cells 0 and 26 of a (3, 3, 3) x cc 1 grid, 26 rows
    apart, meet across the periodic corner when the box edge is 26 *
    PAD_STEP + 1 (r2 = 3): the plain version gives both pad rows a force
    (f64: in f32 the shifted sentinels round onto each other)."""
    g = _pad_x(27, torch.float64, "cpu").reshape(1, 27, 1).repeat(3, 1, 1)
    prd = torch.full((3,), 26 * PAD_STEP + 1.0, dtype=torch.float64)
    ref = lj_cell_force_reference(KEY, (3, 3, 3), g[0], g[1], g[2], prd)
    assert ref[:, 0].abs().max().item() > 0
    assert ref[:, 26].abs().max().item() > 0
    return g.to(cuda), prd.to(cuda)


@pytest.mark.parametrize("inputs", [_huge_box, _corner_pads])
def test_walks_every_row_where_pads_could_meet(cuda, inputs):
    """Where the box does not keep pads out of the cutoff of every other
    row (csrc/lj_cell_force.cu, conditions (b) and (c)), the kernel cannot
    skip them and walks every row, as the plain version does."""
    g, prd = inputs(cuda)
    _launch_and_check(KEY, (3, 3, 3), g, prd, torch.float64)


def test_pad_cutoff_raises(cuda):
    """A cutoff of PAD_STEP or more could pair two pads: the wrapper raises
    before any launch (tests/test_torch_pair_kernel.py: the check on the
    CPU)."""
    g = torch.zeros(27, 8, dtype=torch.float64, device=cuda)
    prd = torch.ones(3, dtype=torch.float64, device=cuda)
    before = lj_cell_force.launches
    with pytest.raises(ValueError, match="pad spacing"):
        lj_cell_force(("lj", 48.0, 24.0, 256.0), (3, 3, 3), g, g, g, prd)
    assert lj_cell_force.launches == before


def planted_pairs(dtype, targets, spacing=8.0, own0=(3.5, 1.5, 1.5)):
    """Positions of len(targets) pairs, pair k at r2 == targets[k] exactly
    as `rn_r2` rounds it: own at own0 + (spacing k, 0, 0), the candidate
    2.3 below it in x and about 0.95 and 0.31 of the rest of the distance
    below it in y and z, found by a search over the ulps of its y and z.
    Pairs sit `spacing` apart in x, beyond each other's cutoff. Returns a
    [2 len(targets), 3] float64 array of values exact in `dtype`."""
    np_t = np.float32 if dtype == torch.float32 else np.float64
    out = []
    for k, target in enumerate(targets):
        own = np.array([own0[0] + spacing * k, own0[1], own0[2]], dtype=np_t)
        cx = own[0] - np_t(2.3)
        dx = float(own[0] - cx)
        rest = np.sqrt(float(target) - dx * dx)
        base_y = own[1] - np_t(0.95 * rest)
        base_z = own[2] - np_t(np.sqrt(1 - 0.95 ** 2) * rest)
        found = None
        for i in range(-400, 401):
            cy = base_y + np_t(i) * np.spacing(base_y)
            for j in range(-40, 41):
                cand = np.array([cx, cy, base_z + np_t(j) * np.spacing(
                    base_z)], dtype=np_t)
                if rn_r2(own, cand) == target:
                    found = cand
                    break
            if found is not None:
                break
        assert found is not None, f"no position gives r2 {target!r}"
        out += [own.astype(np.float64), found.astype(np.float64)]
    return np.array(out)


def rn_r2(own, cand):
    """r2 of own - cand with each product and sum rounded in the inputs'
    type, in the kernels' order."""
    d = own - cand
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def boundary_targets(dtype):
    """cutsq and the values one ulp below and above it, in `dtype`."""
    np_t = np.float32 if dtype == torch.float32 else np.float64
    c = np_t(KEY[3])
    return [c, np.nextafter(c, np_t(0)), np.nextafter(c, np_t(10))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cutoff_boundary_pairs(cuda, dtype):
    """Pairs planted at r2 = cutsq, one ulp below and one ulp above: only
    the pair below is inside the cutoff, in the kernel as in the plain
    version."""
    pos = planted_pairs(dtype, boundary_targets(dtype))
    ncells, cc, side = (8, 3, 3), 32, 3.0
    g = np.repeat(_pad_x(72 * cc, torch.float64, "cpu").numpy()[None], 3,
                  axis=0).reshape(3, 72, cc)
    for i, p in enumerate(pos):  # atom i at lane i of its cell
        cell = (p // side).astype(int)
        g[:, (cell[0] * 3 + cell[1]) * 3 + cell[2], i] = p
    g = torch.from_numpy(g).to(dtype).to(cuda)
    prd = torch.tensor([24.0, 9.0, 9.0], dtype=dtype, device=cuda)
    f, ref = _launch_and_check(KEY, ncells, g, prd, dtype)
    flat = ref.reshape(3, -1).abs().sum(0)
    assert int((flat > 0).sum()) == 2  # the pair one ulp below only
    assert torch.equal(f.reshape(3, -1).abs().sum(0) > 0, flat > 0)


def test_kernel_rejects_bad_input(cuda):
    key = ("lj", 48.0, 24.0, 6.25)
    g = torch.zeros(27, 8, 2, device=cuda)[..., 0]  # non-contiguous
    prd = torch.ones(3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lj_cell_force(key, (3, 3, 3), g, g, g, prd)
    with pytest.raises(ValueError, match="prd"):
        lj_cell_force(key, (3, 3, 3), g.contiguous(), g.contiguous(),
                      g.contiguous(), prd.double())


def test_launch_shape(cuda):
    """The launch the library reports: one warp per cell, four cells a
    block, within the default 48 KB of shared memory."""
    for dtype in (torch.float32, torch.float64):
        big = pair_kernels.launch_shape((37, 37, 37), dtype)
        assert big["threads"] == (32, 4)
        assert big["blocks"] == -(-37 ** 3 // 4)
        assert 0 < big["smem_bytes"] <= 48 * 1024


@pytest.mark.parametrize("case", planted.CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cutoff_frame_across_wrapped_faces(cuda, dtype, case):
    """A pair planted across each periodic face at K1's r2 = cutsq and one
    ulp either side (prof/planted.wrapped_pairs, (3, 3, 3) x cc 32): the
    kernel takes on both rows of each pair the decision of the plain
    version, which is K1's (tests/test_torch_cutoff_frame.py)."""
    ncells, cc = (3, 3, 3), 32
    prd = torch.full((3,), 10.2, dtype=dtype)
    g, _, rows, dec = planted.wrapped_pairs(ncells, cc, prd, KEY[3], dtype,
                                            case, device=cuda)
    f, ref = _launch_and_check(KEY, ncells, g, prd.to(cuda), dtype)
    want = {axis: d["half"] for axis, d in dec.items()}
    assert planted.taken(ref, rows) == want
    assert planted.taken(f, rows) == want
    assert int(f.count_nonzero()) == int(ref.count_nonzero())
