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

The tally instance (thermo rows, `lj_cell_force_tally`) is held against
its twin on the same inputs: forces and pe plane with the tolerances
above; the six virial planes in f64 likewise; the sums over the valid rows
(float64 on both sides) pe rtol 1e-12 in f64, 1e-5 in f32, the virial
rtol 1e-12 with atol 1e-12*max|virial| in f64. In f32 a row's virial is a
sum of pair terms that cancel, so f32's own rounding of it is far above
1e-4 of its largest value: there the kernel's virial planes and sums are
held to an f64 evaluation of the same inputs within twice the f32 twin's
own deviation from it, plus 1e-4 (planes) or 1e-5 (sums) of the largest
value, the rule tests/test_torch_eam_cuda.py holds EAM's f32 virial to.
The tally launch's forces equal the step kernel's to a few ulps (the same
walk; only the compiler's scheduling differs), and its cutoff decisions
are the step's.
"""

import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu_torch.ops import gridforce, pair_kernels
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import (
    lj_cell_force,
    lj_cell_force_reference,
    lj_cell_force_tally,
    lj_cell_force_tally_reference,
    tally_sums,
)
from lammps_kokkos_port_tpu_torch.ops.sortedforce import (
    PAD_POS,
    PAD_STEP,
    _pad_x,
)
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
from lammps_kokkos_port_tpu_torch.prof import planted
from lammps_kokkos_port_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

KEY = ("lj", 48.0, 24.0, 6.25)  # lj/cut 2.5, epsilon = sigma = 1
# its tally keys: lj3, lj4 and no offset; and the offset of `pair_modify
# shift yes`, which takes a pair at the cutoff to an energy of about 0
TALLY_KEY = ("lj", 48.0, 24.0, 4.0, 4.0, 0.0, 6.25)
SHIFTED_KEY = TALLY_KEY[:5] + (4.0 * (2.5 ** -12 - 2.5 ** -6), 6.25)


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


def _as_accurate(got, twin, exact, rel):
    """`got` within twice the twin's deviation from `exact` (the same
    values evaluated in f64), plus `rel` of the largest |exact|."""
    allowed = (2 * (twin.double() - exact).abs().max()
               + rel * exact.abs().max()).item()
    worst = (got.double() - exact).abs().max().item()
    assert worst <= allowed, (worst, allowed)


def _tally_and_check(tkey, ncells, g, prd, dtype, valid=None):
    """One tally launch (and no step launch) against its twin: forces and
    the seven planes row by row, pe and virial summed over the `valid` rows
    (every row where None); its forces against the step kernel's on the
    same inputs. Returns (f, tally, the twin's f, the twin's tally)."""
    before = (lj_cell_force.launches, lj_cell_force_tally.launches)
    f, tally = lj_cell_force_tally(tkey, ncells, g[0], g[1], g[2], prd)
    torch.cuda.synchronize()
    assert (lj_cell_force.launches, lj_cell_force_tally.launches) == (
        before[0], before[1] + 1)
    f_ref, tally_ref = lj_cell_force_tally_reference(tkey, ncells, g[0],
                                                     g[1], g[2], prd)
    _assert_matches(f, f_ref, dtype)
    _assert_matches(tally[0], tally_ref[0], dtype)
    if valid is None:
        valid = torch.ones(g[0].numel(), dtype=torch.bool, device=g.device)
    sums, ref = tally_sums(tally, valid), tally_sums(tally_ref, valid)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(sums[0], ref[0], rtol=tol,
                               atol=tol * ref[0].abs().item())
    vmax = ref[1:].abs().max().clamp_min(1e-300).item()
    if dtype == torch.float64:
        _assert_matches(tally[1:], tally_ref[1:], dtype)
        torch.testing.assert_close(sums[1:], ref[1:], rtol=tol,
                                   atol=tol * vmax)
    else:
        exact = lj_cell_force_tally_reference(
            tkey, ncells, *(a.double() for a in (g[0], g[1], g[2], prd)))[1]
        _as_accurate(tally[1:], tally_ref[1:], exact[1:], 1e-4)
        _as_accurate(sums[1:], ref[1:], tally_sums(exact, valid)[1:], tol)
    step = lj_cell_force(tkey[:3] + tkey[6:], ncells, g[0], g[1], g[2], prd)
    torch.cuda.synchronize()
    ulps = 8 * torch.finfo(dtype).eps
    torch.testing.assert_close(f, step, rtol=ulps,
                               atol=ulps * step.abs().max().item())
    return f, tally, f_ref, tally_ref


@pytest.mark.parametrize("cells", [6, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tally_matches_plain(cuda, dtype, cells):
    """The tally instance on the jittered melt: 6 cells, and 20, the lj-melt
    32k deck's grid; its own key (offset 0) and the shifted one."""
    sim = lj_melt_sim(cells=cells, t_init=1.44, dtype=dtype, device=cuda)
    sim.setup()
    st, p = sim.state, sim.nl.params
    gen = torch.Generator(device=cuda).manual_seed(cells)
    jitter = (torch.rand(st.x.shape, generator=gen, device=cuda,
                         dtype=dtype) - 0.5) * 0.1
    x = torch.where(st.valid_mask[:, None], st.x + jitter, st.x)
    g = x.t().contiguous().reshape(3, p.total_cells, p.cell_cap)
    assert sim.pair_style.tally_key()[3:6] == (4.0, 4.0, 0.0)
    for tkey in (sim.pair_style.tally_key(), SHIFTED_KEY):
        _, tally, _, _ = _tally_and_check(tkey, p.ncells, g, st.box.prd,
                                          dtype, st.valid_mask)
        assert tally[0].abs().max().item() > 1.0
        assert tally[1:].abs().max().item() > 1.0


def _interleaved(cuda, dtype, cc, ncells):
    ncell = ncells[0] * ncells[1] * ncells[2]
    counts = [(c * 7) % (cc // 2) + 4 for c in range(ncell)]
    if cc == 64:
        counts[5] = 40
    return _lattice_grid(ncells, cc, counts, 11, dtype, cuda)


@pytest.mark.parametrize("grid,dtype", [
    ("interleaved32", torch.float32), ("interleaved32", torch.float64),
    ("interleaved64", torch.float32), ("interleaved64", torch.float64),
    ("huge_box", torch.float64), ("corner_pads", torch.float64)])
def test_tally_on_padded_grids(cuda, grid, dtype):
    """The tally instance on the step kernel's hard inputs: pads before
    live rows (cc 32, and cc 64 with a cell of 40 atoms in two row passes),
    and where pads could meet (every row walked): there the pads' planes
    are the twin's, and the sums over the valid rows leave them out."""
    if grid.startswith("interleaved"):
        cc = int(grid[-2:])
        ncells = (3, 4, 5) if cc == 32 else (3, 3, 4)
        g, prd, valid = _interleaved(cuda, dtype, cc, ncells)
        valid = valid.reshape(-1)
    else:
        g, prd = (_huge_box if grid == "huge_box" else _corner_pads)(cuda)
        ncells, valid = (3, 3, 3), None
    f, tally, _, tally_ref = _tally_and_check(SHIFTED_KEY, ncells, g, prd,
                                              dtype, valid)
    if valid is not None:
        pads = ~valid
        assert tally_ref[0].reshape(-1)[valid].abs().max().item() > 0.1
        assert torch.equal(tally.reshape(7, -1)[:, pads],
                           torch.zeros_like(tally.reshape(7, -1)[:, pads]))
    if grid == "corner_pads":
        none = torch.zeros(27, dtype=torch.bool, device=cuda)
        assert tally[0].reshape(-1)[[0, 26]].abs().min().item() > 0
        assert bool((tally_sums(tally, none) == 0).all())


@pytest.mark.parametrize("case", planted.CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tally_cutoff_decisions(cuda, dtype, case):
    """Pairs planted at r2 = cutsq and one ulp either side, and across each
    periodic face at K1's r2 = cutsq and one ulp either side: the tally
    instance takes each row's decision as the step kernel and the twin
    take it (K1's), in its forces and in its energy plane (unshifted: a
    pair at the cutoff keeps an energy of about -0.0163)."""
    ncells, cc = (3, 3, 3), 32
    prd = torch.full((3,), 10.2, dtype=dtype)
    g, _, rows, dec = planted.wrapped_pairs(ncells, cc, prd, KEY[3], dtype,
                                            case, device=cuda)
    f, tally, f_ref, _ = _tally_and_check(TALLY_KEY, ncells, g,
                                          prd.to(cuda), dtype)
    want = {axis: d["half"] for axis, d in dec.items()}
    assert planted.taken(f_ref, rows) == want
    assert planted.taken(f, rows) == want
    pe = tally[0].reshape(-1)
    assert {axis: tuple(bool(pe[r] != 0) for r in pair)
            for axis, pair in enumerate(rows)} == want
    if case != "at":
        return
    # the in-box pairs at cutsq and one ulp either side (as
    # test_cutoff_boundary_pairs plants them): only the one below counts
    pos = planted_pairs(dtype, boundary_targets(dtype))
    side = 3.0
    gb = np.repeat(_pad_x(72 * cc, torch.float64, "cpu").numpy()[None], 3,
                   axis=0).reshape(3, 72, cc)
    for i, p in enumerate(pos):
        cell = (p // side).astype(int)
        gb[:, (cell[0] * 3 + cell[1]) * 3 + cell[2], i] = p
    gb = torch.from_numpy(gb).to(dtype).to(cuda)
    box = torch.tensor([24.0, 9.0, 9.0], dtype=dtype, device=cuda)
    f, tally, _, _ = _tally_and_check(TALLY_KEY, (8, 3, 3), gb, box, dtype)
    assert int((tally[0].reshape(-1) != 0).sum()) == 2
    assert int((f.reshape(3, -1).abs().sum(0) > 0).sum()) == 2


def test_thermo_row_launches_the_tally_once(cuda, monkeypatch):
    """A thermo row on the card: one tally launch, no launch of the step
    kernel and no grid-roll pass; the row against the same row on the CPU
    (the twin)."""
    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64, device=cuda)
    sim.setup()
    cpu = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64,
                      device="cpu")
    cpu.setup()

    def no_roll(*args, **kwargs):
        raise AssertionError("grid-roll pass on the sorted layout")

    monkeypatch.setattr(gridforce, "compute", no_roll)
    before = (lj_cell_force.launches, lj_cell_force_tally.launches)
    trace.reset()
    trace.enable()
    try:
        row = sim.thermo()
        counters = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert (lj_cell_force.launches, lj_cell_force_tally.launches) == (
        before[0], before[1] + 1)
    assert counters == {"pair.lj_tally_rows": 1}
    ref = cpu.thermo()
    for k in ("pe", "press", "pxx", "pxy"):
        assert row[k] == pytest.approx(ref[k], rel=1e-10, abs=1e-10), k
