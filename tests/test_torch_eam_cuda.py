"""PyTorch port, the two CUDA EAM sweeps against their plain twins.

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). The
kernels are built from the repository's source at first use. Run it on
the card with:

    python -m pytest --noconftest -m cuda tests/test_torch_eam_cuda.py

(`--noconftest`: the suite's conftest configures jax, which this file does
not use.) Inputs: the sorted state of the bench/in.eam deck at cells 6
after setup(), on the synthetic Sutton-Chen stand-in potential, positions
jittered by a seeded +-0.08 A, and planted grids (pairs at the cutoff,
clamped u and rho, interleaved pads at cc 64, pads meeting across the
periodic corner). Tolerances: f64 rtol 1e-10 with atol 1e-10*max|value|;
f32 rtol 1e-4 with atol 1e-4*max|value|. Kernel and twin make the same
cutoff decisions (r2 is rounded alike); the Chebyshev series and the sums
differ in rounding and order. The fused fp = F'(rho) is held against
`embedding_fp` of the plain rho with the same tolerances.

The tally instances (thermo rows) are held against their twins row by
row with the same tolerances, and their sums over rows (float64 on both
sides) tighter: pe rtol 1e-12 in f64, 1e-5 in f32; the virial rtol 1e-12
with atol 1e-12*max|virial| in f64 (a component may be near zero). In f32
a row's virial is a sum of pair terms that cancel (fpair itself is the
difference of the embedding and pair parts), so f32's own rounding of it
is far above 1e-4 of its largest value: the f32 twin differs from an f64
evaluation of the same inputs by about 5e-3 of the largest summed
component on the deck's lattice. There the kernel's virial planes and sums
are held to the f64 evaluation within twice the f32 twin's own deviation
from it, plus 1e-4 (planes) or 1e-5 (sums) of the largest value: the
kernel is as accurate as the plain version in the same type. The tally
launch's forces equal the step instance's to a few ulps (the same walk
and series; only the compiler's scheduling differs).
"""

import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu_torch.io.eam_reader import (
    write_sutton_chen_funcfl,
)
from lammps_kokkos_port_tpu_torch.models.pair_eam import make_eam_funcfl
from lammps_kokkos_port_tpu_torch.ops import eam_kernels, eamdense
from lammps_kokkos_port_tpu_torch.ops.eamdense import embedding_fp
from lammps_kokkos_port_tpu_torch.ops.sortedforce import (
    PAD_POS,
    PAD_STEP,
    _pad_x,
)
from lammps_kokkos_port_tpu_torch.presets import eam_bulk_cu_sim
from lammps_kokkos_port_tpu_torch.utils import trace
from test_torch_pair_kernel_cuda import _lattice_grid, planted_pairs

pytestmark = pytest.mark.cuda

SIDE = 5.0  # cell edge of the planted grids: above the 4.95 A cutoff


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


def _tabs(tmp_path):
    """The stand-in's tables: (rho_tab, force_tab, fp_tab, tables)."""
    pot = write_sutton_chen_funcfl(tmp_path / "sc.eam")
    style = make_eam_funcfl(1, {1: pot}, dtype=torch.float64, device="cpu")
    tabs = style.poly_tables
    cutsq = float(style.cutmax) ** 2
    return (eam_kernels.rho_tab(tabs, cutsq),
            eam_kernels.force_tab(tabs, cutsq), eam_kernels.fp_tab(tabs),
            tabs)


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


def _sweeps_match(tabs3, ncells, g, valid, prd, dtype):
    """The fused rho sweep and the force sweep (fed the twin's fp) against
    their twins, one launch each. Returns the twins' (rho, fp, f)."""
    rtab, ftab, fptab = tabs3
    n_rho, n_force = (eam_kernels.eam_cell_rho.launches,
                      eam_kernels.eam_cell_force.launches)
    rho, fp = eam_kernels.eam_cell_rho_fp(rtab, fptab, ncells, g[0], g[1],
                                          g[2], valid, prd)
    torch.cuda.synchronize()
    rho_ref, fp_ref = eam_kernels.eam_cell_rho_fp_reference(
        rtab, fptab, ncells, g[0], g[1], g[2], valid, prd)
    _assert_close(rho, rho_ref, dtype)
    _assert_close(fp, fp_ref, dtype)
    fp_ref = fp_ref.contiguous()
    f = eam_kernels.eam_cell_force(ftab, ncells, g[0], g[1], g[2], fp_ref,
                                   prd)
    torch.cuda.synchronize()
    f_ref = eam_kernels.eam_cell_force_reference(ftab, ncells, g[0], g[1],
                                                 g[2], fp_ref, prd)
    _assert_close(f, f_ref, dtype)
    assert (eam_kernels.eam_cell_rho.launches,
            eam_kernels.eam_cell_force.launches) == (n_rho + 1, n_force + 1)
    return rho_ref, fp_ref, f_ref


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

    # the fused sweep: the same rho, and fp against embedding_fp of it
    _, fp_ref, _ = _sweeps_match((rtab, ftab, eam_kernels.fp_tab(tabs)),
                                 p.ncells, g, sim.state.valid_mask, prd,
                                 dtype)
    _assert_close(fp_ref.reshape(-1), fp.to(dtype), dtype)
    assert bool((fp_ref.reshape(-1)[~sim.state.valid_mask] == 0).all())


def _planted_grid(pos, ncells, cc, dtype, device):
    """Atom i of `pos` at lane i of its cell (edge SIDE), pads elsewhere.
    Returns (g [3, ncell, cc], valid [ncell * cc], the atoms' rows)."""
    nx, ny, nz = ncells
    g = np.repeat(_pad_x(nx * ny * nz * cc, torch.float64, "cpu").numpy()[
        None], 3, axis=0).reshape(3, nx * ny * nz, cc)
    valid = np.zeros((nx * ny * nz, cc), dtype=bool)
    rows = []
    for i, p in enumerate(pos):
        c = (p // SIDE).astype(int)
        cell = (c[0] * ny + c[1]) * nz + c[2]
        g[:, cell, i] = p
        valid[cell, i] = True
        rows.append(cell * cc + i)
    return (torch.from_numpy(g).to(dtype).to(device),
            torch.from_numpy(valid.reshape(-1)).to(device), rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cutoff_boundary_pairs(cuda, tmp_path, dtype):
    """Pairs planted at r2 = cutsq, one ulp below and one ulp above: only
    the pair below is inside the cutoff, in both sweeps as in the plain
    versions (g and the force are not 0 at the cutoff)."""
    tabs3 = _tabs(tmp_path)[:3]
    np_t = np.float32 if dtype == torch.float32 else np.float64
    c = np_t(tabs3[0][3])
    targets = [c, np.nextafter(c, np_t(0)), np.nextafter(c, np_t(100))]
    pos = planted_pairs(dtype, targets, own0=(3.5, 7.5, 7.5))
    ncells = (5, 3, 3)
    g, valid, _ = _planted_grid(pos, ncells, 32, dtype, cuda)
    prd = torch.tensor([25.0, 15.0, 15.0], dtype=dtype, device=cuda)
    rho, _, f = _sweeps_match(tabs3, ncells, g, valid, prd, dtype)
    inside = rho.reshape(-1) > 0
    assert int(inside.sum()) == 2  # the pair one ulp below only
    assert torch.equal(inside, f.reshape(3, -1).abs().sum(0) > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_clamped_u_and_rho(cuda, tmp_path, dtype):
    """u below the fits' u_lo (a pair 1.2 A apart, whose rho then exceeds
    rho_hi), rho below rho_lo (a pair 4 A apart) and rho = 0 (an atom
    alone): the clamps of both sweeps and of the fp epilogue."""
    *tabs3, tabs = _tabs(tmp_path)
    pos = np.array([[2.0, 2.0, 2.0], [3.2, 2.0, 2.0],
                    [12.0, 7.5, 7.5], [16.0, 7.5, 7.5],
                    [7.5, 12.5, 12.5]])
    ncells = (4, 3, 3)
    g, valid, rows = _planted_grid(pos, ncells, 32, dtype, cuda)
    prd = torch.tensor([20.0, 15.0, 15.0], dtype=dtype, device=cuda)
    rho, fp, f = _sweeps_match(tabs3, ncells, g, valid, prd, dtype)
    rho_lo, rho_hi = tabs["rho_range"]
    assert 1.2 ** 2 < tabs["u_range"][0]
    r = rho.reshape(-1)[rows].tolist()
    assert r[0] > rho_hi and r[1] > rho_hi
    assert 0 < r[2] < rho_lo and 0 < r[3] < rho_lo and r[4] == 0
    assert bool((fp.reshape(-1)[valid] != 0).all())
    forces = f.reshape(3, -1)[:, rows].abs().sum(0).tolist()
    assert min(forces[:4]) > 0 and forces[4] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_interleaved_pads_cc64(cuda, tmp_path, dtype):
    """Pads before live rows at cc 64, one cell holding 40 atoms (its rows
    run in two passes of one warp)."""
    tabs3 = _tabs(tmp_path)[:3]
    ncells = (3, 3, 4)
    ncell = 36
    counts = [(c * 7) % 32 + 4 for c in range(ncell)]
    counts[5] = 40
    g, prd, valid = _lattice_grid(ncells, 64, counts, 11, dtype, cuda,
                                  side=SIDE)
    rho, fp, f = _sweeps_match(tabs3, ncells, g, valid.reshape(-1), prd,
                               dtype)
    assert f[:, valid].abs().max().item() > 1.0
    assert bool((fp[~valid] == 0).all())


def _huge_box(cuda):
    """max(prd) >= PAD_POS / 4: pads cannot be told by position."""
    g, _, valid = _lattice_grid((3, 3, 3), 32, [5] * 27, 3, torch.float64,
                                cuda, side=SIDE)
    prd = torch.full((3,), PAD_POS / 4, dtype=torch.float64, device=cuda)
    return g, prd, valid.reshape(-1)


def _corner_pads(cuda):
    """The pads of cells 0 and 26 of a (3, 3, 3) x cc 1 grid, 26 rows
    apart, meet across the periodic corner when the box edge is 26 *
    PAD_STEP + 1 (r2 = 3): the plain versions give both pad rows a density
    and a force."""
    g = _pad_x(27, torch.float64, "cpu").reshape(1, 27, 1).repeat(3, 1, 1)
    prd = torch.full((3,), 26 * PAD_STEP + 1.0, dtype=torch.float64)
    return (g.to(cuda), prd.to(cuda),
            torch.zeros(27, dtype=torch.bool, device=cuda))


@pytest.mark.parametrize("inputs", [_huge_box, _corner_pads])
def test_walks_every_row_where_pads_could_meet(cuda, tmp_path, inputs):
    """Where the box does not keep pads out of the cutoff of every other
    row (csrc/sorted_grid.cuh, conditions (b) and (c)), both sweeps walk
    every row, as the plain versions do; fp follows the valid mask."""
    g, prd, valid = inputs(cuda)
    rho, fp, f = _sweeps_match(_tabs(tmp_path)[:3], (3, 3, 3), g, valid,
                               prd, torch.float64)
    if inputs is _corner_pads:
        assert rho[0, 0] > 0 and rho[26, 0] > 0
        assert f[:, 0, 0].abs().max() > 0 and f[:, 26, 0].abs().max() > 0
        assert bool((fp == 0).all())


def test_force_pass_launches_each_sweep_once(cuda, tmp_path, monkeypatch):
    """The force-only pass on the card: one rho+fp launch and one force
    launch, and no call of embedding_fp (the fp glue is the rho sweep's
    epilogue)."""
    sim = _sim(tmp_path, torch.float32, cuda)

    def no_glue(*args, **kwargs):
        raise AssertionError("embedding_fp called on the card's path")

    monkeypatch.setattr(eam_kernels, "embedding_fp", no_glue)
    monkeypatch.setattr(eamdense, "embedding_fp", no_glue)
    before = (eam_kernels.eam_cell_rho.launches,
              eam_kernels.eam_cell_force.launches)
    f, pe, vir = eamdense.compute(sim.pair_style, sim.state, sim.nl, False,
                                  False)
    torch.cuda.synchronize()
    assert pe is None and vir is None and bool(torch.isfinite(f).all())
    assert (eam_kernels.eam_cell_rho.launches,
            eam_kernels.eam_cell_force.launches) == (before[0] + 1,
                                                     before[1] + 1)


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


def test_launch_shapes(cuda):
    """One warp per cell, four cells a block, within the default 48 KB of
    shared memory (the force sweep's packed f64 records included)."""
    for name in ("eam_cell_rho", "eam_cell_force"):
        for dtype in (torch.float32, torch.float64):
            s = eam_kernels.launch_shape(name, (37, 37, 37), dtype)
            assert s["threads"] == (32, 4)
            assert s["blocks"] == -(-37 ** 3 // 4)
            assert 0 < s["smem_bytes"] <= 48 * 1024


def test_kernels_reject_bad_input(cuda, tmp_path):
    sim = _sim(tmp_path, torch.float32, cuda)
    p = sim.nl.params
    g, prd, rtab, ftab, tabs = _grid_inputs(sim, torch.float32)
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
    fptab = eam_kernels.fp_tab(tabs)
    with pytest.raises(ValueError, match="valid"):
        eam_kernels.eam_cell_rho_fp(rtab, fptab, p.ncells, g[0], g[1], g[2],
                                    sim.state.valid_mask.cpu(), prd)
    with pytest.raises(ValueError, match="coefficients"):
        eam_kernels.eam_cell_rho_fp(rtab, (fptab[0][:-1],) + fptab[1:],
                                    p.ncells, g[0], g[1], g[2],
                                    sim.state.valid_mask, prd)
    # a cutoff that could pair two pads: raised before any launch
    before = (eam_kernels.eam_cell_rho.launches,
              eam_kernels.eam_cell_force.launches)
    with pytest.raises(ValueError, match="pad spacing"):
        eam_kernels.eam_cell_rho(rtab[:3] + (256.0,), p.ncells, g[0], g[1],
                                 g[2], prd)
    with pytest.raises(ValueError, match="pad spacing"):
        eam_kernels.eam_cell_force(ftab[:4] + (256.0,), p.ncells, g[0], g[1],
                                   g[2], g[0], prd)
    assert before == (eam_kernels.eam_cell_rho.launches,
                      eam_kernels.eam_cell_force.launches)


def _tally_counts():
    return (eam_kernels.eam_cell_rho.launches,
            eam_kernels.eam_cell_force.launches,
            eam_kernels.eam_cell_rho_tally.launches,
            eam_kernels.eam_cell_force_tally.launches)


def _tallies_match(tabs, ncells, g, valid, prd, dtype):
    """Both tally sweeps against their twins, one launch each (the force
    tally fed the twin's fp and e), and the tally launch's forces against
    the step instance's on the same inputs; the sums over rows. Returns the
    twins' (rho, fp, e, tally)."""
    rtab, ftab, fptab, etab, phitab = tabs
    before = _tally_counts()
    rho, fp, e = eam_kernels.eam_cell_rho_tally(rtab, fptab, etab, ncells,
                                                g[0], g[1], g[2], valid, prd)
    torch.cuda.synchronize()
    rho_ref, fp_ref, e_ref = eam_kernels.eam_cell_rho_tally_reference(
        rtab, fptab, etab, ncells, g[0], g[1], g[2], valid, prd)
    for got, ref in ((rho, rho_ref), (fp, fp_ref), (e, e_ref)):
        _assert_close(got, ref, dtype)
    assert bool((e[~valid.reshape(e.shape)] == 0).all())
    fp_ref, e_ref = fp_ref.contiguous(), e_ref.contiguous()
    f, tally = eam_kernels.eam_cell_force_tally(
        ftab, phitab, ncells, g[0], g[1], g[2], fp_ref, e_ref, prd)
    torch.cuda.synchronize()
    f_ref, tally_ref = eam_kernels.eam_cell_force_tally_reference(
        ftab, phitab, ncells, g[0], g[1], g[2], fp_ref, e_ref, prd)
    _assert_close(f, f_ref, dtype)
    exact = None
    if dtype == torch.float64:
        for k in range(7):
            _assert_close(tally[k], tally_ref[k], dtype)
    else:
        _assert_close(tally[0], tally_ref[0], dtype)
        exact = eam_kernels.eam_cell_force_tally_reference(
            ftab, phitab, ncells, *(a.double() for a in (
                g[0], g[1], g[2], fp_ref, e_ref)), prd.double())[1]
        for k in range(1, 7):
            _as_accurate(tally[k], tally_ref[k], exact[k], 1e-4)
    assert _tally_counts() == (before[0], before[1], before[2] + 1,
                               before[3] + 1)
    step_f = eam_kernels.eam_cell_force(ftab, ncells, g[0], g[1], g[2],
                                        fp_ref, prd)
    torch.cuda.synchronize()
    ulps = 8 * torch.finfo(dtype).eps
    torch.testing.assert_close(f, step_f, rtol=ulps,
                               atol=ulps * step_f.abs().max().item())
    sums = tally.reshape(7, -1).sum(1, dtype=torch.float64)
    ref = tally_ref.reshape(7, -1).sum(1, dtype=torch.float64)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    vmax = ref[1:].abs().max().clamp_min(1e-300)
    line = (f"[tally {dtype}] pe {sums[0].item():.17g} twin "
            f"{ref[0].item():.17g} rel {(sums[0] / ref[0] - 1).abs():.3g}; "
            f"virial vs twin rel-to-max "
            f"{(sums[1:] - ref[1:]).abs().max() / vmax:.3g}")
    torch.testing.assert_close(sums[0], ref[0], rtol=tol,
                               atol=tol * ref[0].abs().item())
    if exact is None:
        torch.testing.assert_close(sums[1:], ref[1:], rtol=tol,
                                   atol=tol * vmax.item())
    else:
        whole = exact.reshape(7, -1).sum(1)[1:]
        gap = (sums[1:] - whole).abs().max() / vmax
        line += (f"; vs f64: kernel {gap:.3g}"
                 f", twin {(ref[1:] - whole).abs().max() / vmax:.3g}; planes "
                 f"vs f64: kernel {(tally[1:] - exact[1:]).abs().max():.3g}, "
                 f"twin {(tally_ref[1:] - exact[1:]).abs().max():.3g}")
        _as_accurate(sums[1:], ref[1:], whole, tol)
    print(f"{line}; forces vs step max abs "
          f"{(f - step_f).abs().max().item():.3g}")
    return rho_ref, fp_ref, e_ref, tally_ref


def _as_accurate(got, twin, exact, rel):
    """`got` within twice the twin's deviation from `exact` (the same
    values evaluated in f64), plus `rel` of the largest |exact|."""
    allowed = (2 * (twin.double() - exact).abs().max()
               + rel * exact.abs().max()).item()
    worst = (got.double() - exact).abs().max().item()
    assert worst <= allowed, (worst, allowed)


def _tally_tabs(tabs, cutsq):
    """The tally sweeps' constants: (rho_tab, force_tab, fp_tab, embed_tab,
    phi_tab)."""
    return (eam_kernels.rho_tab(tabs, cutsq),
            eam_kernels.force_tab(tabs, cutsq), eam_kernels.fp_tab(tabs),
            eam_kernels.embed_tab(tabs), eam_kernels.phi_tab(tabs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tally_kernels_match_twin(cuda, tmp_path, dtype):
    """The tally sweeps on the jittered deck state (cells 6): rho, fp, e,
    forces and the seven planes row by row, pe and virial summed; the
    forces equal the step instance's."""
    sim = _sim(tmp_path, dtype, cuda)
    p = sim.nl.params
    g, prd, *_ = _grid_inputs(sim, dtype)
    cutsq = float(sim.pair_style.cutmax) ** 2
    _, _, e, tally = _tallies_match(
        _tally_tabs(sim.pair_style.poly_tables, cutsq), p.ncells, g,
        sim.state.valid_mask, prd, dtype)
    assert e.abs().max().item() > 1.0 and tally[1:].abs().max() > 0.01


def _clamped_grid(dtype, device):
    """test_clamped_u_and_rho's planted atoms: two rows above rho_hi (the
    embedding energy's linear extension), two below rho_lo, one alone."""
    pos = np.array([[2.0, 2.0, 2.0], [3.2, 2.0, 2.0],
                    [12.0, 7.5, 7.5], [16.0, 7.5, 7.5],
                    [7.5, 12.5, 12.5]])
    ncells = (4, 3, 3)
    g, valid, _ = _planted_grid(pos, ncells, 32, dtype, device)
    prd = torch.tensor([20.0, 15.0, 15.0], dtype=dtype, device=device)
    return ncells, g, valid, prd


def _interleaved_grid(dtype, device):
    """test_interleaved_pads_cc64's grid: pads before live rows at cc 64,
    one cell of 40 atoms."""
    ncells = (3, 3, 4)
    counts = [(c * 7) % 32 + 4 for c in range(36)]
    counts[5] = 40
    g, prd, valid = _lattice_grid(ncells, 64, counts, 11, dtype, device,
                                  side=SIDE)
    return ncells, g, valid.reshape(-1), prd


@pytest.mark.parametrize("grid,dtype", [
    ("interleaved", torch.float32), ("interleaved", torch.float64),
    ("clamped", torch.float32), ("clamped", torch.float64),
    ("huge_box", torch.float64), ("corner_pads", torch.float64)])
def test_tallies_on_planted_and_padded_grids(cuda, tmp_path, grid, dtype):
    """The tally sweeps against their twins on padded and interleaved-pad
    grids (cc 64), on rows above rho_hi and below rho_lo, and where pads
    could meet (every row walked, e 0 on every pad)."""
    tabs3 = _tabs(tmp_path)
    tabs = _tally_tabs(tabs3[3], tabs3[0][3])
    if grid == "interleaved":
        ncells, g, valid, prd = _interleaved_grid(dtype, cuda)
    elif grid == "clamped":
        ncells, g, valid, prd = _clamped_grid(dtype, cuda)
    else:
        g, prd, valid = (_huge_box if grid == "huge_box" else
                         _corner_pads)(cuda)
        ncells = (3, 3, 3)
    rho, fp, e, tally = _tallies_match(tabs, ncells, g, valid, prd, dtype)
    if grid == "clamped":
        above = rho.reshape(-1) > tabs3[3]["rho_range"][1]
        assert int(above.sum()) == 2
        assert bool((fp.reshape(-1)[above] != 0).all())
    if grid == "corner_pads":
        # the pads' planes (the kernel's, held to these above) are left out
        # of the sums: no valid row, so pe and virial are 0 (grid_roll's)
        assert bool((e == 0).all()) and tally[0, 0, 0] != 0
        assert bool((eam_kernels.tally_sums(tally, valid) == 0).all())


def test_thermo_row_launches_each_tally_once(cuda, tmp_path, monkeypatch):
    """A thermo row on the card: one launch of each tally sweep, none of
    the step's sweeps and none of the grid-roll path; the row's pe and
    press against the same row on the CPU (the twins)."""
    sim = _sim(tmp_path, torch.float64, cuda)
    cpu = _sim(tmp_path, torch.float64, torch.device("cpu"))

    def no_roll(*args, **kwargs):
        raise AssertionError("grid-roll path on the sorted layout")

    monkeypatch.setattr(eamdense, "grid_roll", no_roll)
    before = _tally_counts()
    trace.reset()
    trace.enable()
    try:
        row = sim.thermo()
        counters = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert _tally_counts() == (before[0], before[1], before[2] + 1,
                               before[3] + 1)
    assert counters == {"pair.eam_tally_rows": 1}
    ref = cpu.thermo()
    for k in ("pe", "press", "pxx", "pxy", "fmax"):
        assert row[k] == pytest.approx(ref[k], rel=1e-10, abs=1e-10), k
