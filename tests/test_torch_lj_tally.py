"""PyTorch port, lj/cut thermo rows on the sorted layout: the tally twin.

A thermo row (an energy/virial pass) on the sorted layout runs the tally
instance of the lj cell force kernel (`pair_kernels.lj_cell_force_tally`);
CPU tensors run its plain twin `lj_cell_force_tally_reference`. Held here
against the port's independent grid-roll pass (`ops/gridforce.compute`,
itself held to the JAX package by tests/test_torch_gridforce.py) on the
jittered 6-cell melt, in f32 and f64, with the energy shift off and on:
forces on the valid rows, pe and the six virial sums. Tolerances: f64
rtol 1e-10 (the two sum the same pair terms in another order, Newton-half
against the full stencil); f32 rtol 1e-5 on pe and 1e-4 with atol 1e-4 of
the largest value on forces and virial, whose rows cancel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu_torch.core.box import Box
from lammps_kokkos_port_tpu_torch.models.pair_lj import make_lj_cut
from lammps_kokkos_port_tpu_torch.ops import gridforce, pair_kernels
from lammps_kokkos_port_tpu_torch.ops import sortedforce as sf
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
from lammps_kokkos_port_tpu_torch.prof.grid import resort
from lammps_kokkos_port_tpu_torch.utils import trace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once, and each worker's intra-op thread
    pool would otherwise claim every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def melt():
    """{dtype: (sim, state, list)}: the 6-cell melt after setup(), 32
    atoms in each cell of its 3 x 3 x 3 grid, with pads at the end of each
    cell (f32: its own cell_cap 64; f64: re-sorted at cell_cap 48),
    positions jittered by a seeded +-0.05."""
    out = {}
    for dt in (torch.float32, torch.float64):
        sim = lj_melt_sim(cells=6, t_init=1.44, dtype=dt, device="cpu")
        sim.setup()
        st, p = sim.state, sim.nl.params
        if p.cell_cap == 32:
            st, p = resort(sim, 48)
        x = st.x.double().numpy().copy()
        valid = st.valid_mask.numpy()
        rng = np.random.default_rng(6)
        x[valid] += rng.uniform(-0.05, 0.05, (int(valid.sum()), 3))
        cl = sf.SortedCells(ago=0, nbuilds=1, overflow=torch.tensor(False),
                            params=p)
        out[dt] = sim, st.replace(x=torch.from_numpy(x).to(dt)), cl
    return out


def _style(sim, shift: bool):
    """The melt's lj/cut 2.5 (epsilon = sigma = 1), with the energy shift
    (`pair_modify shift yes`: offset = evdwl at the cutoff) where asked."""
    if not shift:
        return sim.pair_style
    style = make_lj_cut(1, {(1, 1): (1.0, 1.0)}, 2.5, shift=True,
                        dtype=sim.state.dtype, device="cpu")
    assert style.tally_key()[5] < -0.01
    return style


def grid_roll(style, state, cl, eflag=True, vflag=True):
    """`gridforce.compute` on the identity buckets the sorted layout
    implies (each cell's rows, pads marked by the capacity)."""
    p = cl.params
    cap, ntot, cc = state.capacity, p.total_cells, p.cell_cap
    rows = torch.arange(cap, dtype=torch.int32).reshape(ntot, cc)
    buckets = torch.where(state.mask.reshape(ntot, cc) != 0, rows, cap)
    buckets = torch.cat([buckets,
                         torch.full((1, cc), cap, dtype=torch.int32)])
    return gridforce.compute(style, state,
                             gridforce.GridCells(buckets=buckets, params=p),
                             eflag, vflag)


@pytest.mark.parametrize("shift", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tally_twin_matches_grid_roll(melt, dtype, shift):
    """The sorted thermo path (the tally twin) against the grid-roll pass
    on the same state: forces, pe and virial; on the CPU no kernel is
    launched."""
    sim, st, cl = melt[dtype]
    style = _style(sim, shift)
    before = pair_kernels.lj_cell_force_tally.launches
    f, pe, vir = pair_kernels.compute_sorted(style, st, cl, True, True)
    assert pair_kernels.lj_cell_force_tally.launches == before
    f_ref, pe_ref, vir_ref = grid_roll(style, st, cl)
    assert pe.dtype == vir.dtype == f.dtype == dtype and vir.shape == (6,)
    valid = st.valid_mask.numpy()
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(f.numpy()[valid], f_ref.numpy()[valid],
                               rtol=tol,
                               atol=tol * np.abs(f_ref.numpy()).max())
    np.testing.assert_allclose(pe.item(), pe_ref.item(),
                               rtol=1e-10 if dtype == torch.float64 else 1e-5)
    np.testing.assert_allclose(vir.numpy(), vir_ref.numpy(), rtol=tol,
                               atol=tol * np.abs(vir_ref.numpy()).max())
    assert abs(pe.item()) > 1.0 and np.abs(vir.numpy()).max() > 1.0
    # the shift moves pe by offset per pair, and the forces not at all
    if shift:
        _, pe0, _ = pair_kernels.compute_sorted(sim.pair_style, st, cl,
                                                True, False)
        assert pe.item() - pe0.item() > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tally_twin_holds_its_planes(melt, dtype):
    """The tally twin's forces are the force twin's bit for bit (one walk),
    pads' planes are zero, and its planes summed over the valid rows
    (`tally_sums`, float64) are pe and the virial of the thermo path."""
    sim, st, cl = melt[dtype]
    p = cl.params
    g = sf.planar(st.x).reshape(3, p.total_cells, p.cell_cap)
    args = (p.ncells, g[0], g[1], g[2], st.box.prd)
    f, tally = pair_kernels.lj_cell_force_tally(sim.pair_style.tally_key(),
                                                *args)
    assert tally.shape == (7, p.total_cells, p.cell_cap)
    assert tally.dtype == dtype
    assert torch.equal(f, pair_kernels.lj_cell_force_reference(
        sim.pair_style.kernel_key(), *args))
    pads = ~st.valid_mask.reshape(p.total_cells, p.cell_cap)
    assert bool(pads.any())
    assert torch.equal(tally[:, pads], torch.zeros_like(tally[:, pads]))
    sums = pair_kernels.tally_sums(tally, st.valid_mask)
    assert sums.dtype == torch.float64
    _, pe, vir = pair_kernels.compute_sorted(sim.pair_style, st, cl,
                                             True, True)
    assert torch.equal(sums[0].to(dtype), pe)
    assert torch.equal(sums[1:].to(dtype), vir)


def test_tally_key():
    """`tally_key` carries the style's energy coefficients and offset
    beside `kernel_key`'s, read once; None at more than one type, where
    the sorted mode is not offered."""
    style = make_lj_cut(1, {(1, 1): (1.0, 1.0)}, 2.5, shift=True,
                        dtype=torch.float64)
    key = style.tally_key()
    assert key[0] == "lj" and key is style.tally_key()
    assert key[1:3] == style.kernel_key()[1:3]
    assert key[6] == style.kernel_key()[3]
    assert key[3:6] == pytest.approx((4.0, 4.0, 4.0 * (2.5 ** -12
                                                       - 2.5 ** -6)))
    two = make_lj_cut(2, {(1, 1): (1.0, 1.0), (2, 2): (1.0, 1.1)}, 2.5)
    assert two.tally_key() is None and two.kernel_key() is None


def test_tally_sums_leave_out_pads_that_meet(melt):
    """A (3, 3, 3) x cc 1 sorted grid whose box edge is 26 * PAD_STEP + 1:
    the pads of rows 0 and 26 meet across the periodic corner (r2 = 3), so
    the twin gives them a pair energy and a virial. The thermo path sums
    only the valid rows' planes, as the grid-roll pass masks pads: pe and
    virial equal its (zero: the atoms sit far apart). (x, mask and box
    are replaced; the other per-row fields are not read.)"""
    sim, st, cl = melt[torch.float64]
    edge = 26 * sf.PAD_STEP + 1.0
    x = sf._pad_x(27, torch.float64, "cpu")[:, None].repeat(1, 3)
    mask = torch.zeros(27, dtype=torch.int32)
    # rows 1-25 hold atoms off the box's diagonal (where the pads lie) and
    # far from each other: no pair of any kind reaches them
    for row in range(1, 26):
        c = np.array([row // 9, row // 3 % 3, row % 3])
        x[row] = torch.from_numpy((c + 0.5) * edge / 3 + [10.0, -20.0, 30.0])
        mask[row] = 1
    box = Box.create([0.0] * 3, [edge] * 3)
    corner = st.replace(x=x, mask=mask, box=box)
    params = dataclasses.replace(cl.params, ncells=(3, 3, 3), cell_cap=1)
    cl = sf.SortedCells(ago=0, nbuilds=1, overflow=torch.tensor(False),
                        params=params)
    _, pe, vir = pair_kernels.compute_sorted(sim.pair_style, corner, cl, True,
                                             True)
    _, pe_ref, vir_ref = grid_roll(sim.pair_style, corner, cl)
    assert pe.item() == pe_ref.item() == 0.0
    assert torch.equal(vir, vir_ref) and not bool(vir.any())
    g = sf.planar(x).reshape(3, 27, 1)
    _, tally = pair_kernels.lj_cell_force_tally(
        sim.pair_style.tally_key(), (3, 3, 3), g[0], g[1], g[2], box.prd)
    pads = tally.reshape(7, 27)[:, [0, 26]]
    assert bool((pads[0] != 0).all()) and bool((pads[1:4] != 0).all())
    assert tally.reshape(7, -1).sum(1)[0].abs() > 1e-3


def test_thermo_rows_count_and_skip_grid_roll(melt, monkeypatch):
    """`pair.lj_tally_rows` counts each energy/virial pass on the sorted
    layout, a thermo row of `Simulation.thermo` among them, and none of
    them reaches the grid-roll pass; force-only passes count nothing, and
    pe and virial come back only where asked for."""
    sim, st, cl = melt[torch.float64]
    pe_ref = grid_roll(sim.pair_style, st, cl, True, False)[1]

    def no_roll(*args, **kwargs):
        raise AssertionError("grid-roll pass on the sorted layout")

    monkeypatch.setattr(gridforce, "compute", no_roll)
    trace.reset()
    trace.enable()
    try:
        f, pe, vir = pair_kernels.compute_sorted(sim.pair_style, st, cl,
                                                 True, False)
        assert vir is None
        assert pe.item() == pytest.approx(pe_ref.item(), rel=1e-12)
        _, pe, vir = pair_kernels.compute_sorted(sim.pair_style, st, cl,
                                                 False, True)
        assert pe is None and vir.shape == (6,)
        f0, pe, vir = pair_kernels.compute_sorted(sim.pair_style, st, cl,
                                                  False, False)
        assert pe is None and vir is None and torch.equal(f0, f)
        assert trace.snapshot()["counters"] == {"pair.lj_tally_rows": 2}
        row = sim.thermo()
        assert trace.snapshot()["counters"] == {"pair.lj_tally_rows": 3}
    finally:
        trace.disable()
        trace.reset()
    assert np.isfinite(row["pe"]) and np.isfinite(row["press"])


@pytest.mark.parametrize("wrapper,key", [
    (pair_kernels.lj_cell_force, ("lj", 48.0, 24.0, 6.25)),
    (pair_kernels.lj_cell_force_tally,
     ("lj", 48.0, 24.0, 4.0, 4.0, 0.0, 6.25))], ids=["step", "tally"])
def test_non_cpu_tensors_never_reach_the_twins(wrapper, key):
    """A tensor off the CPU goes to the kernel or raises (meta tensors: no
    kernel for that device); a key of another style raises."""
    g = torch.zeros(27, 8, dtype=torch.float64, device="meta")
    prd = torch.ones(3, dtype=torch.float64, device="meta")
    before = wrapper.launches
    with pytest.raises(NotImplementedError, match="device"):
        wrapper(key, (3, 3, 3), g, g, g, prd)
    with pytest.raises(NotImplementedError, match="style"):
        wrapper(("eam",) + key[1:], (3, 3, 3), g, g, g, prd)
    assert wrapper.launches == before
