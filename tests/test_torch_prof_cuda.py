"""PyTorch port, the CUDA kernels of the profiling paths against their
plain twins: K7, P6 and P7 (csrc/lj_column_full.cu: K7 and k1 on the
shared walk, on any grid, pairs at the cutoff across a wrapped face,
bit-repeatable), K8 and P10 (csrc/lj_plane_half.cu), P9 and P4
(csrc/lj_ablate.cu: any lane count, and a time that grows with the
lanes), the Newton-half column passes P2, P3, P5, P8 and P11 (csrc/lj_column_half.cu), P1
(csrc/dynslice.cu) and P12 (csrc/zwin_proto.cu: two gathers in one
launch, against the twin, whose reactions are added window by window, at
the script's shape, a small one and where windows read one column), and
the graph-replayed slope of prof.timing against the eager one. K7, P6 k1
and k2 (k1's walk with group sums) are held on any grid, at cc 64 and
across wrapped faces, and repeat bit for bit.

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). The
kernels are built from the repository's sources at first use. Run on the
card with:

    python -m pytest --noconftest -m cuda tests/test_torch_prof_cuda.py

(`--noconftest`: the suite's conftest configures jax, which this file does
not use.) Inputs: the sorted state of the 864-atom melt, positions
jittered by a seeded +-0.05, and for K8 and P10 planted grids (pairs at
the cutoff across a wrapped face, interleaved pads, a 40-atom cell at cc
64, pads meeting across the periodic corner, ids out of row order).
Tolerances: f64 rtol 1e-10, f32 rtol 1e-4,
each with atol rtol*max|f|: kernel and twin make the same cutoff decisions
(r2 rounded alike) and sum in other orders; K8's reactions are summed by
shared-memory atomics and global reductions, in an order that changes
from run to run. P9's
approximate reciprocal (rcp.approx.ftz.f32, at most 1 ulp off) is held to
the exact twin within the same f32 tolerance; so are P2's and P11's, which
add one Newton step (in f64 seeded from the f32 approximation, about
2^-46 relative after the step, inside the f64 tolerance). P12 runs in
f32 only (the approximate reciprocal): its random inputs hold
near-coincident pairs (max|f| about 1e14), so each element is held to its
own scale, the sum of the magnitudes of its terms (zwin_kernels
`max_scaled_error`), within 1e-4; planted faults (a window start moved by
one, a neighbour column off by one) fail that check. P1 sums window values
in the same order as its twin (rtol 1e-6).
"""

import dataclasses
import time

import pytest
import torch

from lammps_kokkos_port_tpu_torch.ops import column_kernels, half_kernels
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import lj_cell_force
from lammps_kokkos_port_tpu_torch.ops.sortedforce import (PAD_POS, PAD_STEP,
                                                         _pad_x)
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
from lammps_kokkos_port_tpu_torch.prof import ablate_kernels as ak
from lammps_kokkos_port_tpu_torch.prof import column_half_kernels as chk
from lammps_kokkos_port_tpu_torch.prof import dynslice, timing
from lammps_kokkos_port_tpu_torch.prof import dynslice_kernels as dk
from lammps_kokkos_port_tpu_torch.prof import planted, v3_kernels
from lammps_kokkos_port_tpu_torch.prof import zwin_kernels as zk
from lammps_kokkos_port_tpu_torch.prof.grid import sorted_planes
from test_torch_pair_kernel_cuda import (KEY, _lattice_grid,
                                         boundary_targets, planted_pairs)

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


def _half_check(args, dtype, react=True):
    """One counted launch of K8 (`react`) or P10 on `args` against its twin
    (never called on the card's tensors); returns (kernel, twin) as [3, n]
    force planes."""
    fn = (half_kernels.lj_plane_half_force if react
          else half_kernels.lj_plane_half_fwd)
    before = fn.launches
    got = torch.stack([a.reshape(-1) for a in fn(*args)])
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    plain = (half_kernels.lj_plane_half_force_reference if react
             else half_kernels.lj_plane_half_fwd_reference)
    ref = torch.stack([a.reshape(-1) for a in plain(*args)])
    _assert_close(got, ref, dtype)
    return got, ref


def _plane_args(key, ncells, g, ids, prd, idcap=None):
    """K8's arguments from [3, ncell, cc] positions and [ncell, cc] ids."""
    shape = (*ncells, g.shape[-1])
    return (key, ncells, ids.numel() if idcap is None else idcap,
            *(a.reshape(shape) for a in g), ids.reshape(shape), prd)


def _ids(valid):
    """Float ids of the plane layout: the row where valid, else -1."""
    rows = torch.arange(valid.numel(), device=valid.device).reshape(
        valid.shape)
    return torch.where(valid, rows, -1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plane_half_cutoff_boundary_across_a_wrapped_face(cuda, dtype):
    """Pairs planted at r2 = cutsq and one ulp either side, each across the
    periodic x face: the own row sits in the last x cell and its candidate,
    in the first, is reached by the half stencil's wrapped (1, 0, 0) entry
    shifted by +Lx (exactly: the planted x lies in [Lx, 2 Lx]). Only the
    pair one ulp below the cutoff gives forces, in both instances and
    their twins."""
    side, ncells, cc = 3.0, (3, 8, 3), 32
    lx = ncells[0] * side
    g = _pad_x(72 * cc, torch.float64, "cpu").repeat(3, 1).reshape(
        3, 72, cc)
    valid = torch.zeros(72, cc, dtype=torch.bool)
    for k, target in enumerate(boundary_targets(dtype)):
        pos = planted_pairs(dtype, [target], own0=(lx + 0.8, 2.5 + 9 * k,
                                                   1.5))
        assert lx <= pos[0, 0] <= 2 * lx
        pos[0, 0] -= lx  # exact: Sterbenz
        for i, p in enumerate(pos):
            c = (p // side).astype(int)
            cell = (c[0] * ncells[1] + c[1]) * ncells[2] + c[2]
            g[:, cell, 2 * k + i] = torch.from_numpy(p)
            valid[cell, 2 * k + i] = True
    prd = torch.tensor([lx, 24.0, 9.0], dtype=dtype, device=cuda)
    args = _plane_args(KEY, ncells, g.to(dtype).to(cuda),
                       _ids(valid).to(dtype).to(cuda), prd)
    for react in (True, False):
        got, ref = _half_check(args, dtype, react)
        hit = ref.abs().sum(0) > 0
        # the pair one ulp below: both rows with reactions, one without
        assert int(hit.sum()) == (2 if react else 1)
        assert torch.equal(got.abs().sum(0) > 0, hit)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cc,ncells", [(32, (3, 4, 5)), (64, (3, 3, 4))])
def test_plane_half_interleaved_pads_and_row_passes(cuda, dtype, cc, ncells):
    """Pads among live rows; at cc 64 one cell holds 40 atoms, so its rows
    run in two row passes of one warp, and the own cell's reactions from
    one pass land on rows of the other."""
    ncell = ncells[0] * ncells[1] * ncells[2]
    counts = [(c * 7) % (cc // 2) + 4 for c in range(ncell)]
    if cc == 64:
        counts[5] = 40
    g, prd, valid = _lattice_grid(ncells, cc, counts, 11, dtype, cuda)
    args = _plane_args(KEY, ncells, g, _ids(valid).to(dtype), prd)
    for react in (True, False):
        got, ref = _half_check(args, dtype, react)
        assert ref[:, valid.reshape(-1)].abs().max().item() > 1.0
        pads = ~valid.reshape(-1)
        assert torch.equal(got[:, pads], torch.zeros_like(got[:, pads]))
    if cc == 64:  # the 40-atom cell's rows of its second pass
        second = valid[5].clone()
        second[:32] = False
        assert bool(second.any())
        assert got.reshape(3, ncell, cc)[:, 5, second].abs().sum(0).min() > 0


def _huge_box_planes(cuda):
    """max(prd) >= PAD_POS / 4: pads cannot be told by position."""
    g, _, valid = _lattice_grid((3, 3, 3), 32, [5] * 27, 3, torch.float64,
                                cuda)
    prd = torch.full((3,), PAD_POS / 4, dtype=torch.float64, device=cuda)
    return g, valid, prd


def _corner_planes(real_row0: bool):
    """The pad sentinels of a (3, 3, 3) x cc 1 grid in a box of edge 26 *
    PAD_STEP + 1, where rows 0 and 26 meet across the periodic corner (r2
    = 3), which breaks the pad premise. All pads (id -1), or row 0 a real
    atom (id 0) at its sentinel: then the half stencil reaches it from
    row 26 (a pad, id -1) through the wrapped (1, 1, 1) entry, and the id
    rule -1 < 0 + idcap gives the pair."""
    g = _pad_x(27, torch.float64, "cpu").reshape(1, 27, 1).repeat(3, 1, 1)
    valid = torch.zeros(27, 1, dtype=torch.bool)
    valid[0, 0] = real_row0
    prd = torch.full((3,), 26 * PAD_STEP + 1.0, dtype=torch.float64)
    return g, valid, prd


@pytest.mark.parametrize("inputs", ["huge_box", "corner_pads",
                                    "corner_pad_and_atom"])
def test_plane_half_walks_every_row_where_pads_could_meet(cuda, inputs):
    """Where the box does not keep pads out of every cutoff (sorted_grid.cuh,
    conditions (b) and (c)), both instances walk every row and every
    candidate and the id rule decides, as in the twins: two pads (-1 < -1)
    take no pair; a pad own row takes one with a real candidate inside the
    cutoff."""
    if inputs == "huge_box":
        g, valid, prd = _huge_box_planes(cuda)
    else:
        g, valid, prd = (a.to(cuda) for a in _corner_planes(
            inputs == "corner_pad_and_atom"))
    args = _plane_args(KEY, (3, 3, 3), g, _ids(valid).to(torch.float64), prd)
    for react in (True, False):
        got, ref = _half_check(args, torch.float64, react)
        if inputs == "corner_pads":
            assert torch.equal(ref, torch.zeros_like(ref))
            assert torch.equal(got, torch.zeros_like(got))
        elif inputs == "corner_pad_and_atom":
            assert ref[:, 26].abs().max() > 0  # the pad own row's pair
            assert (ref[:, 0].abs().max() > 0) == react


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("idcap", ["cap", 0])
def test_plane_half_ids_not_in_row_order(cuda, dtype, idcap):
    """Ids permuted among the real rows, so the pair rule own_id < cand_id
    and not the row order decides which row of a pair evaluates it; with
    idcap 0 it decides across cells too (a pair whose own id is the larger
    is not taken at all, by the twin or by the kernels)."""
    sp = _planes(cuda, dtype)
    ids = sp.ids.clone()
    real = ids >= 0
    gen = torch.Generator(device=cuda).manual_seed(3)
    ids[real] = ids[real][torch.randperm(int(real.sum()), generator=gen,
                                         device=cuda)]
    shape = sp.plane[0].shape
    args = (sp.key, sp.ncells, sp.cap if idcap == "cap" else idcap,
            *sp.plane[:3], ids.reshape(shape), sp.prd)
    for react in (True, False):
        _half_check(args, dtype, react)


def test_plane_half_pad_cutoff_raises(cuda):
    """A cutoff of PAD_STEP or more could pair two pads: both wrappers
    raise before any launch."""
    g = torch.zeros(2, 2, 3, 8, dtype=torch.float64, device=cuda)
    prd = torch.ones(3, dtype=torch.float64, device=cuda)
    for fn in (half_kernels.lj_plane_half_force,
               half_kernels.lj_plane_half_fwd):
        before = fn.launches
        with pytest.raises(ValueError, match="pad spacing"):
            fn(("lj", 48.0, 24.0, 256.0), (2, 2, 3), 96, g, g, g, g, prd)
        assert fn.launches == before


def test_plane_half_launch_shape(cuda):
    """The launch the library reports: one warp per cell, four cells a
    block, within the default 48 KB of shared memory; K8's reaction
    accumulators on top of P10's."""
    for dtype in DTYPES:
        k8 = half_kernels.launch_shape((37, 37, 37), dtype)
        p10 = half_kernels.launch_shape((37, 37, 37), dtype, react=False)
        for s in (k8, p10):
            assert s["threads"] == (32, 4)
            assert s["blocks"] == -(-37 ** 3 // 4)
            assert 0 < s["smem_bytes"] <= 48 * 1024
        assert k8["smem_bytes"] > p10["smem_bytes"]


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
    # P4: 512 lanes
    ref = ak.pair_only_reference(sp.key, sp.ncells, *live, ids, sp.prd,
                                 lanes=512)
    _assert_close(ak.pair_only(sp.key, sp.ncells, *live, ids, sp.prd,
                               lanes=512), ref, dtype)
    if dtype == torch.float64:
        with pytest.raises(TypeError, match="float32"):
            ak.pair_only_approx(sp.key, sp.ncells, *live, ids, sp.prd)


def _column_case(case, cuda, dtype):
    """The column passes' arguments (key, ncells, idcap, gx, gy, gz, gi,
    prd) on one of the inputs the walk finds hard."""
    if case in ("melt", "permuted_ids_idcap0", "live_pad"):
        sp = _planes(cuda, dtype)
        col, idcap = sp.col, sp.cap
        if case == "permuted_ids_idcap0":
            ids = sp.ids.clone()
            real = ids >= 0
            gen = torch.Generator(device=cuda).manual_seed(3)
            ids[real] = ids[real][torch.randperm(
                int(real.sum()), generator=gen, device=cuda)]
            col, idcap = (*col[:3], ids.reshape(col[3].shape)), 0
        elif case == "live_pad":
            col = _live_pad(sp)[0]
        return (sp.key, sp.ncells, idcap, *col, sp.prd)
    if case == "corner_pad_and_atom":  # pads not apart (f64)
        g, valid, prd = (a.to(cuda) for a in _corner_planes(True))
        ncells = (3, 3, 3)
    else:
        ncells, cc = {"cc64_interleaved": ((3, 3, 4), 64),
                      "nx2_ny2": ((2, 2, 4), 32)}[case]
        ncell = ncells[0] * ncells[1] * ncells[2]
        counts = [(c * 7) % (cc // 2) + 4 for c in range(ncell)]
        if cc == 64:
            counts[5] = 40  # two row passes
        g, prd, valid = _lattice_grid(ncells, cc, counts, 13, dtype, cuda)
    cc = g.shape[-1]
    shape = (ncells[0] * ncells[1], ncells[2], cc)
    return (KEY, ncells, valid.numel(), *(a.reshape(shape) for a in g),
            _ids(valid).to(g.dtype).reshape(shape), prd.to(g.dtype))


COLUMN_CASES = [(dt, case) for dt in DTYPES for case in (
    "melt", "permuted_ids_idcap0", "live_pad", "cc64_interleaved",
    "nx2_ny2")] + [(torch.float64, "corner_pad_and_atom")]


@pytest.mark.parametrize("dtype,case", COLUMN_CASES)
@pytest.mark.parametrize("name", list(chk.PASSES))
def test_column_half_passes_match_twins(cuda, dtype, case, name,
                                        monkeypatch):
    """Each pass against its twin on the inputs the walk finds hard: ids
    out of row order with idcap 0 (the id rule decides across cells), a
    pad row 0.84 from a real row, pads meeting across the periodic corner
    (not apart: every row walked, the mask decides), 40 atoms in a cell of
    cc 64 (two row passes) among interleaved pads, and an nx = 2, ny = 2
    grid (entries (1, -1) and (1, 1) reach one column, as two target
    blocks: P8's rc is held block by block)."""
    args = _column_case(case, cuda, dtype)
    ref = chk.reference(name, *args)
    _no_plain(monkeypatch, chk, "_plain")
    fn = chk.PASSES[name]
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    if name == "iso_noassembly":
        assert all(bool(a.isnan().all()) for a in got)
        return
    if name == "writeonce":
        nx, ny, nz = args[1]
        rc, rc_ref = (a.reshape(nx * ny, 3, nz, len(chk.TARGETS), -1)
                      for a in (got[3], ref[3]))
        for t in range(len(chk.TARGETS)):
            _assert_close(rc[:, :, :, t], rc_ref[:, :, :, t], dtype)
        got, ref = got[:3], ref[:3]
    if max(a.abs().max().item() for a in ref) > 0:
        _assert_close(got, ref, dtype)
    else:
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(chk.PASSES))
def test_column_half_z_chunks(cuda, dtype, name):
    """Every z chunk a pass is compiled for (chk.ZB: those its entry points
    ask for) gives its twin's result; a chunk it is not compiled for
    raises before any launch."""
    sp = _planes(cuda, dtype)
    args = (sp.key, sp.ncells, sp.cap, *sp.col, sp.prd)
    ref = chk.reference(name, *args)
    fn = chk.PASSES[name]
    for zb in (None, *chk.ZB[name]):
        got = fn(*args, zb=zb)
        torch.cuda.synchronize()
        if name == "iso_noassembly":
            assert all(bool(a.isnan().all()) for a in got)
        else:
            _assert_close(got, ref, dtype)
    before = fn.launches
    with pytest.raises(ValueError, match="is not compiled"):
        fn(*args, zb=5)
    assert fn.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_iso_full_equals_k8(cuda, dtype):
    """P5 full and K8 compute one function on one buffer: every component
    within the tolerance."""
    sp = _planes(cuda, dtype)
    iso = chk.iso_full(sp.key, sp.ncells, sp.cap, *sp.col, sp.prd)
    k8 = half_kernels.lj_plane_half_force(sp.key, sp.ncells, sp.cap,
                                          *sp.plane, sp.prd)
    _assert_close([a.reshape(-1) for a in iso],
                  [a.reshape(-1) for a in k8], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_column_half_forces_equal_full_stencil(cuda, dtype):
    """P5 full and batched, P2 and P8 folded: the full stencil's forces."""
    sp = _planes(cuda, dtype)
    args = (sp.key, sp.ncells, sp.cap, *sp.col, sp.prd)
    f1 = [a.reshape(-1) for a in lj_cell_force(sp.key, sp.ncells,
                                               *sp.flat[:3], sp.prd)]
    for forces in (chk.iso_full(*args), chk.iso_batched(*args),
                   chk.halfv2(*args), chk.halfv2_approx(*args),
                   chk.wo_half_force(*args)):
        _assert_close([a.reshape(-1) for a in forces], f1, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_v3_kernels_match_twins_and_k7(cuda, dtype, monkeypatch):
    """P6 k1 (P7's instance) and k2 against their twins, each other and K7
    (no pad within the cutoff on the melt: the same forces)."""
    sp = _planes(cuda, dtype)
    args = (sp.key, sp.ncells, *sp.col, sp.prd)
    k7 = column_kernels.lj_column_force(*args)
    got = {}
    for name in ("v3_k1", "v3_k2"):
        ref = v3_kernels.v3_reference(*args, grouped=name == "v3_k2")
        fn = getattr(v3_kernels, name)
        before = fn.launches
        with monkeypatch.context() as m:
            _no_plain(m, v3_kernels, "v3_reference")
            got[name] = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _assert_close(got[name], ref, dtype)
        _assert_close(got[name], k7, dtype)
    _assert_close(got["v3_k2"], got["v3_k1"], dtype)


def _live_pad(sp):
    """Copies of sp.col with the row after a cell's first real row made a
    pad (id -1) 0.84 from that row along x, inside the cutoff; (col, real
    row, pad row) in flat indices."""
    col = tuple(a.clone() for a in sp.col)
    flat = [a.reshape(-1) for a in col]
    real = int(torch.nonzero(flat[3] >= 0)[0])  # the first row of a cell
    pad = real + 1
    flat[3][pad] = -1.0
    for d in range(3):
        flat[d][pad] = flat[d][real] + (0.84 if d == 0 else 0.0)
    return col, real, pad


@pytest.mark.parametrize("dtype", DTYPES)
def test_v3_kernels_keep_their_candidate_mask(cuda, dtype):
    """P6 k1 and k2 with a pad inside the cutoff of a real row: against
    their twins (cand_id >= 0: the pad acts on no row), and unlike K7, which
    takes the pad as a candidate of the real row (K7 against its twin on
    the same input)."""
    sp = _planes(cuda, dtype)
    col, real, _ = _live_pad(sp)
    args = (sp.key, sp.ncells, *col, sp.prd)
    k7 = column_kernels.lj_column_force(*args)
    _assert_close(k7, column_kernels.lj_column_force_reference(*args), dtype)
    for name in ("v3_k1", "v3_k2"):
        got = getattr(v3_kernels, name)(*args)
        _assert_close(got, v3_kernels.v3_reference(
            *args, grouped=name == "v3_k2"), dtype)
        assert abs(float(got[0].reshape(-1)[real])
                   - float(k7[0].reshape(-1)[real])) > 1.0


def _column_grid(ncells, cc, seed, dtype, cuda):
    """K7's arguments on a lattice grid of any shape: jittered atoms at
    random lanes among pads, float ids (row, or -1 for a pad)."""
    ncell = ncells[0] * ncells[1] * ncells[2]
    counts = [(c * 5) % (min(cc, 32) // 2) + 2 for c in range(ncell)]
    if cc > 32:
        counts[ncell // 2] = 40  # two row passes of one warp
    g, prd, valid = _lattice_grid(ncells, cc, counts, seed, dtype, cuda)
    nx, ny, nz = ncells
    shape = (nx * ny, nz, cc)
    ids = _ids(valid).to(dtype)
    return (KEY, ncells, *(a.reshape(shape) for a in g), ids.reshape(shape),
            prd)


def _column_check(args, dtype):
    """K7, k1 (P7's instance) and k2 once each, counted, against their
    twins; returns {name: (kernel, twin)}."""
    out = {}
    for name, fn, plain in (
            ("K7", column_kernels.lj_column_force,
             column_kernels.lj_column_force_reference),
            ("k1", v3_kernels.v3_k1, v3_kernels.v3_reference),
            ("k2", v3_kernels.v3_k2,
             lambda *a: v3_kernels.v3_reference(*a, grouped=True))):
        before = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = plain(*args)
        _assert_close(got, ref, dtype)
        out[name] = (torch.stack([a.reshape(-1) for a in got]),
                     torch.stack([a.reshape(-1) for a in ref]))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ncells,cc", [((1, 1, 1), 16), ((2, 2, 4), 32),
                                       ((3, 3, 3), 32), ((3, 3, 4), 64)])
def test_column_walk_any_grid(cuda, dtype, ncells, cc):
    """K7, k1 and k2 on the walk take any grid the JAX function takes: one
    cell per dim (a row's 26 images carry its id; other rows' images count
    once per stencil entry), two (one column named by two entries with
    other shifts), three, and cc 64 with a 40-atom cell (two row passes;
    k2's first design took cc <= 96 only). k2 gives k1's forces, summed
    in another order."""
    out = _column_check(_column_grid(ncells, cc, 5, dtype, cuda), dtype)
    for _, ref in out.values():
        assert ref.abs().max().item() > 0.01  # pairs within the cutoff
    k1, k2 = out["k1"][0], out["k2"][0]
    _assert_close(list(k2), list(k1), dtype)


@pytest.mark.parametrize("case", planted.CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_column_walk_cutoff_across_wrapped_faces(cuda, dtype, case):
    """A pair planted across each periodic face at r2 = cutsq (in K1's
    frame) and one ulp either side (prof/planted.wrapped_pairs): K7, k1
    and k2 shift the candidate, as JAX K7 does, and take on each row the decision
    of their twins, which form r2 alike."""
    ncells, cc = (3, 3, 3), 32
    prd = torch.full((3,), 10.2, dtype=dtype)
    g, gi, rows, dec = planted.wrapped_pairs(ncells, cc, prd, KEY[3], dtype,
                                             case, device=cuda)
    shape = (9, 3, cc)
    args = (KEY, ncells, *(a.reshape(shape) for a in g), gi.reshape(shape),
            prd.to(cuda))
    want = {axis: d["candidate"] for axis, d in dec.items()}
    for got, ref in _column_check(args, dtype).values():
        assert planted.taken(ref, rows) == want
        assert planted.taken(got, rows) == want
        assert int(got.count_nonzero()) == int(ref.count_nonzero())


@pytest.mark.parametrize("dtype", DTYPES)
def test_column_walk_repeats_bit_for_bit(cuda, dtype):
    """Each row is written once by its lane, no reductions: two launches
    give the same bits."""
    sp = _planes(cuda, dtype)
    args = (sp.key, sp.ncells, *sp.col, sp.prd)
    for fn in (column_kernels.lj_column_force, v3_kernels.v3_k1,
               v3_kernels.v3_k2):
        first, second = fn(*args), fn(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_column_walk_launch_shape(cuda):
    """K7's launch as its library reports it: one warp per cell, four cells
    a block, within the default 48 KB of shared memory."""
    for dtype in DTYPES:
        s = column_kernels.launch_shape((12, 12, 12), dtype)
        assert s["threads"] == (32, 4)
        assert s["blocks"] == 12 ** 3 // 4
        assert 0 < s["smem_bytes"] <= 48 * 1024


def _live_pair_inputs(sp, dtype, cuda):
    """pair_only's live inputs on the grid of `sp`: positions 3 +- [0.8,
    1.6] per axis, ids -1..2."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    gi = sp.col[3]
    live = [3.0 + torch.where(u < 0.5, -1.0, 1.0) * (0.8 + 0.8 * u)
            for u in (torch.rand(a.shape, generator=gen, device=cuda,
                                 dtype=dtype) for a in sp.col[:3])]
    ids = torch.remainder(torch.arange(gi.numel(), device=cuda),
                          4).to(dtype).reshape(gi.shape) - 1
    return (sp.key, sp.ncells, *live, ids, sp.prd)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [1, 7, 449, 896, 2048])
def test_pair_only_lanes_match_twin(cuda, dtype, lanes):
    """pair_only over any number of candidate lanes, each row's lanes split
    over its threads (a tail shorter than the split, odd counts, the
    largest scratch): against the twin's `lanes` equal terms."""
    args = _live_pair_inputs(_planes(cuda, dtype), dtype, cuda)
    ref = ak.pair_only_reference(*args, lanes=lanes)
    assert ref[0].abs().max() > 0
    _assert_close(ak.pair_only(*args, lanes=lanes), ref, dtype)


def test_pair_only_time_grows_with_lanes(cuda):
    """The ablation runs the body on every lane: at twice the lanes the
    kernel takes at least 1.8 times as long (CUDA events around 20 calls,
    median of 3 in turns, on a (24, 24, 24) x cc 32 grid of live inputs,
    where the kernel and not the launch sets the time)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    shape = (24 * 24, 24, 32)
    pos = [3.0 + torch.rand(shape, generator=gen, device=cuda) for _ in
           range(3)]
    ids = torch.remainder(torch.arange(pos[0].numel(), device=cuda),
                          4).float().reshape(shape) - 1
    args = (KEY, (24, 24, 24), *pos, ids,
            torch.full((3,), 72.0, device=cuda))

    def ms(lanes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            ak.pair_only(*args, lanes=lanes)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    ms(448), ms(896)  # warm-up and build
    times = {448: [], 896: []}
    for _ in range(3):
        for lanes in times:
            times[lanes].append(ms(lanes))
    ratio = sorted(times[896])[1] / sorted(times[448])[1]
    assert ratio >= 1.8, times


@pytest.mark.parametrize("dtype", DTYPES)
def test_cc32_half_keeps_its_mask(cuda, dtype):
    """P3 against its twin with a pad inside the cutoff of a real row (the
    pad takes no pair), and equal to P5 full where no pad is near."""
    sp = _planes(cuda, dtype)
    args = (sp.key, sp.ncells, sp.cap, *sp.col, sp.prd)
    _assert_close(chk.cc32_half(*args), chk.iso_full(*args), dtype)
    col, _, pad = _live_pad(sp)
    args = (sp.key, sp.ncells, sp.cap, *col, sp.prd)
    got = chk.cc32_half(*args)
    _assert_close(got, chk.reference("cc32_half", *args), dtype)
    assert all(float(a.reshape(-1)[pad]) == 0.0 for a in got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [512, 128])
def test_dynslice_matches_twin(cuda, dtype, g, monkeypatch):
    starts = dynslice.script_starts(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    ext = torch.randn((dynslice.NCOL, g), generator=gen, device=cuda,
                      dtype=dtype)
    for mode in dk.MODES:
        ref = dk.dynslice_reference(starts, ext, dynslice.W, mode)
        with monkeypatch.context() as m:
            _no_plain(m, dk, "dynslice_reference")
            before = dk.dynslice.launches
            got = dk.dynslice(starts, ext, dynslice.W, mode)
        torch.cuda.synchronize()
        assert dk.dynslice.launches == before + 1
        torch.testing.assert_close(got, ref, rtol=1e-6,
                                   atol=1e-6 * ref.abs().max().item())


@pytest.mark.parametrize("shape", [zk.ZwinShape(), zk.ZwinShape(26, 64),
                                   zk.ZwinShape(2, 64), zk.ZwinShape(12, 64)])
def test_zwin_matches_twin_and_catches_planted_faults(cuda, shape,
                                                      monkeypatch):
    """At NCOL 2 the +1 and -1 windows read one column and +-12 the column
    itself, at NCOL 12 +-12 the column itself: each stays its own term.
    Each output is written once by a fixed sum: two launches are
    bit-equal, one launch a call."""
    inputs = zk.zwin_inputs(shape, device=cuda)
    ref = zk.zwin_reference(*inputs, shape=shape)
    scale = zk.zwin_reference(*inputs, shape=shape, magnitude=True)
    before = zk.zwin_proto.launches
    with monkeypatch.context() as m:
        _no_plain(m, zk, "zwin_reference")
        got = zk.zwin_proto(*inputs, shape=shape)
        # the kernel with a fault planted in its inputs
        moved = zk.zwin_proto(*inputs[:-1], inputs[-1] + 1, shape=shape)
        wrong = zk.zwin_proto(*inputs, shape=dataclasses.replace(
            shape, offsets=(1, -1, 12, -11)))
        again = zk.zwin_proto(*inputs, shape=shape)
    torch.cuda.synchronize()
    assert zk.zwin_proto.launches == before + 4
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert zk.max_scaled_error(got, ref, scale) <= 1e-4
    for bad in (moved, wrong):
        assert zk.max_scaled_error(bad, ref, scale) > 0.1


def test_graph_slope_against_eager(cuda):
    """slope_ms replays CUDA graphs on the card: within an order of
    magnitude of the eager loop's slope (which adds the host's launch
    cost), and the counters credit every replayed launch."""
    sp = _planes(cuda, torch.float32)
    gx, gy, gz, gi = sp.col

    def forces(cgx, cgy, cgz):
        return chk.iso_full(sp.key, sp.ncells, sp.cap, cgx, cgy, cgz, gi,
                            sp.prd)

    body = timing.force_body(forces)
    before = chk.iso_full.launches
    graph = timing.slope_ms(body, (gx, gy, gz), 10, 30, reps=2)
    # eager warm-up 10, untimed replays 10 + 30, two timed pairs
    assert chk.iso_full.launches - before == 10 + 40 + 2 * 40

    def eager(k):
        c = (gx, gy, gz)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            c = body(c)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    eager(10)
    slope = (eager(30) - eager(10)) / 20 * 1e3
    assert 0 < graph < 10 * slope and slope < 10 * graph
