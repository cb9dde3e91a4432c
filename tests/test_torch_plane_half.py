"""PyTorch port, K8 and P10: the plain twins of the Newton-half plane
kernel and of its forward-only ablation against the TPU code (interpret
mode on the CPU).

K8's twin is held against `plane_half_force_pallas`; P10's against a copy
of the forward-only body of benchmarks/prof/prof_v3_iso.py (:42-100, below
with `interpret=True` added): the script builds a 1M-atom simulation when
it is imported, so it cannot be imported here. Inputs: the JAX sorted
state of the 864-atom melt after setup() (grid (3, 3, 3) x cc 32, cap 864),
f64, positions jittered by a seeded +-0.05, float ids `where(valid, row,
-1)`, idcap = cap, as the scripts pass them; and the same with a few rows
made padding (id -1 at the PAD_POS sentinels). Tolerance: rtol 1e-10 with
atol 1e-10*max|f|: the sums run in another order.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lammps_kokkos_port_tpu.ops import pallas_pair as pp
from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch.ops.half_kernels import (
    HALF,
    SOURCE,
    lj_plane_half_force,
    lj_plane_half_force_reference,
    lj_plane_half_fwd,
    lj_plane_half_fwd_reference,
)
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import lj_cell_force
from lammps_kokkos_port_tpu_torch.ops.sortedforce import PAD_POS, PAD_STEP


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fwd_call_of(key, nx, ny, nz, cc, cap, dt):
    """benchmarks/prof/prof_v3_iso.py:42-100 (fwd_kernel, fwd_call), with
    the script's globals as arguments and interpret=True."""

    # variant: forward-only (no rc output, no fold) — WRONG physics, timing only
    def fwd_kernel(key, nz, cc, idcap, prd_ref, *refs):
        views = refs[:20]
        fx, fy, fz = refs[20:23]
        cand_scratch = refs[23]
        cutsq = key[-1]
        cols = {t: views[4 * k:4 * (k + 1)]
                for k, t in enumerate([(0, 0), (0, 1), (1, -1), (1, 0), (1, 1)])}
        zrow = jax.lax.broadcasted_iota(jnp.int32, (nz, 1), 0)
        for s, (dx, dy, dz) in enumerate(pp._HALF):
            prefs = cols[(dx, dy)]
            for ci in range(4):
                col = prefs[ci][0, 0]
                if ci == 3 and s > 0:
                    col = jnp.where(col >= 0.0, col + float(idcap), -1.0)
                blk = pltpu.roll(col, (-dz) % nz, axis=0) if dz else col
                if ci == 2 and dz != 0:
                    seam = (zrow == (nz - 1 if dz > 0 else 0))
                    blk = blk + jnp.where(seam, jnp.float32(dz) * prd_ref[2], 0.0).astype(blk.dtype)
                cand_scratch[ci, :, s * cc:(s + 1) * cc] = blk
        o = cols[(0, 0)]
        own_x = o[0][0, 0][:, :, None]; own_y = o[1][0, 0][:, :, None]
        own_z = o[2][0, 0][:, :, None]; own_i = o[3][0, 0][:, :, None]
        dxv = own_x - cand_scratch[0][:, None, :]
        dyv = own_y - cand_scratch[1][:, None, :]
        dzv = own_z - cand_scratch[2][:, None, :]
        r2 = dxv * dxv + dyv * dyv + dzv * dzv
        ic = cand_scratch[3]
        valid = jnp.logical_and(own_i < ic[:, None, :], r2 < cutsq)
        r2s = jnp.where(valid, r2, 1.0)
        fpair = jnp.where(valid, pp._terms_from_key(key, r2s), 0.0)
        fx[0, 0] = jnp.sum(dxv * fpair, axis=-1)
        fy[0, 0] = jnp.sum(dyv * fpair, axis=-1)
        fz[0, 0] = jnp.sum(dzv * fpair, axis=-1)

    @functools.partial(jax.jit, static_argnames=())
    def fwd_call(gx, gy, gz, gi, prd):
        Lx, Ly = prd[0], prd[1]
        parts = []
        for a, arr in enumerate((gx, gy, gz, gi)):
            pz = jnp.concatenate([arr, arr[:1] + (Lx if a == 0 else 0.0)], axis=0)
            lo = pz[:, -1:] - (Ly if a == 1 else 0.0)
            hi = pz[:, :1] + (Ly if a == 1 else 0.0)
            parts.append(jnp.concatenate([lo, pz, hi], axis=1))
        quad = tuple(parts)
        kern = functools.partial(fwd_kernel, key, nz, cc, cap)
        def view(di, dj):
            return pl.BlockSpec((1, 1, nz, cc), lambda i, j, di=di, dj=dj: (i + di, j + dj, 0, 0), memory_space=pltpu.VMEM)
        in_specs = [pl.BlockSpec(memory_space=pltpu.SMEM)]
        for (dxs, dys) in ((0, 1), (0, 2), (1, 0), (1, 1), (1, 2)):
            in_specs.extend([view(dxs, dys)] * 4)
        outp = pl.BlockSpec((1, 1, nz, cc), lambda i, j: (i, j, 0, 0), memory_space=pltpu.VMEM)
        out_shape = [jax.ShapeDtypeStruct((nx, ny, nz, cc), dt)] * 3
        operands = []
        for _ in range(5):
            operands.extend(quad)
        return pl.pallas_call(kern, grid=(nx, ny), in_specs=in_specs,
                              out_specs=[outp] * 3, out_shape=out_shape,
                              scratch_shapes=[pltpu.VMEM((4, nz, 14 * cc), dt)],
                              interpret=True,
                              )(prd, *operands)

    return fwd_call


@pytest.fixture(scope="module")
def grids():
    """{"sorted": ..., "padded": ...}: plane channels (numpy), ids, key."""
    sim = jax_lj_melt_sim(cells=6, t_init=1.44, dtype=jnp.float64, every=20,
                          delay=0, check=False)
    sim.setup()
    st, p = sim.state, sim.nl.params
    valid = np.asarray(st.valid_mask)
    x = np.array(st.x)
    rng = np.random.default_rng(11)
    x[valid] += rng.uniform(-0.05, 0.05, (int(valid.sum()), 3))
    cap = st.capacity
    ids = np.where(valid, np.arange(cap), -1).astype(np.float64)
    base = dict(key=sim.pair_style.kernel_key(), ncells=tuple(p.ncells),
                cc=p.cell_cap, cap=cap, prd=np.array(st.box.prd))
    # a few own rows become padding rows, as a cell with room to spare
    # holds them: id -1 at the distinct far sentinels
    pads = np.random.default_rng(5).choice(cap, 6, replace=False)
    xp, idp = x.copy(), ids.copy()
    xp[pads] = (PAD_POS + pads * PAD_STEP)[:, None]
    idp[pads] = -1.0
    return {"sorted": dict(base, x=x, ids=ids, pads=np.array([], int)),
            "padded": dict(base, x=xp, ids=idp, pads=pads)}


def _planes(g):
    nx, ny, nz = g["ncells"]
    shape = (nx, ny, nz, g["cc"])
    return [np.ascontiguousarray(g["x"][:, d].reshape(shape))
            for d in range(3)] + [g["ids"].reshape(shape)]


def _torch(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def _assert_close(got, ref):
    fmax = max(np.abs(np.asarray(a)).max() for a in ref)
    assert fmax > 1.0  # jittered: the forces are real
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-10 * fmax)


@pytest.mark.parametrize("case", ["sorted", "padded"])
def test_twin_matches_plane_half_force_pallas(grids, case):
    g = grids[case]
    planes = _planes(g)
    ref = pp.plane_half_force_pallas(
        g["key"], g["ncells"], g["cap"], *(jnp.asarray(a) for a in planes),
        jnp.asarray(g["prd"]))
    args = (g["key"], g["ncells"], g["cap"], *_torch(planes),
            torch.from_numpy(g["prd"]))
    got = lj_plane_half_force_reference(*args)
    _assert_close(got, ref)
    # the CPU wrapper runs the twin and launches nothing
    launches = lj_plane_half_force.launches
    assert all(torch.equal(a, b)
               for a, b in zip(lj_plane_half_force(*args), got))
    assert lj_plane_half_force.launches == launches
    # Newton-half and the full stencil give the same forces on real rows;
    # a padding row pairs with nothing (it sits far from every row)
    cc = g["cc"]
    f1 = lj_cell_force(g["key"], g["ncells"],
                       *(a.reshape(-1, cc) for a in args[3:6]), args[-1])
    real = g["ids"] >= 0
    for d in range(3):
        flat = got[d].reshape(-1).numpy()
        np.testing.assert_allclose(flat[real], f1[d].reshape(-1)[real],
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(flat[g["pads"]], 0.0)


def test_fwd_twin_matches_the_script_body(grids):
    g = grids["padded"]
    planes = _planes(g)
    fwd_call = fwd_call_of(g["key"], *g["ncells"], g["cc"], g["cap"],
                           jnp.float64)
    ref = fwd_call(*(jnp.asarray(a) for a in planes), jnp.asarray(g["prd"]))
    args = (g["key"], g["ncells"], g["cap"], *_torch(planes),
            torch.from_numpy(g["prd"]))
    got = lj_plane_half_fwd_reference(*args)
    _assert_close(got, ref)
    launches = lj_plane_half_fwd.launches
    assert all(torch.equal(a, b) for a, b in zip(lj_plane_half_fwd(*args),
                                                 got))
    assert lj_plane_half_fwd.launches == launches


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 2 ** 24),
                                         (torch.float64, 2 ** 53)])
def test_id_offset_limit(dtype, limit):
    """Ids travel as floats: cap + idcap must stay an exact integer of the
    type; at the limit the offset ids still compare right."""
    key = ("lj", 48.0, 24.0, 6.25)
    ncells, cc = (2, 2, 3), 2
    rng = np.random.default_rng(1)
    x = [torch.from_numpy(rng.uniform(0, 3, (2, 2, 3, cc))).to(dtype)
         for _ in range(3)]
    n = 2 * 2 * 3 * cc
    gi = torch.arange(n, dtype=dtype).reshape(2, 2, 3, cc)
    prd = torch.full((3,), 3.0, dtype=dtype)
    at_limit = lj_plane_half_force(key, ncells, limit - n, *x, gi, prd)
    # the same pairs as any smaller offset that keeps ids apart
    small = lj_plane_half_force(key, ncells, n, *x, gi, prd)
    assert all(torch.equal(a, b) for a, b in zip(at_limit, small))
    with pytest.raises(ValueError, match="exceed"):
        lj_plane_half_force(key, ncells, limit - n + 1, *x, gi, prd)


def test_grid_too_small_raises():
    key = ("lj", 48.0, 24.0, 6.25)
    g = torch.zeros(1, 3, 3, 4, dtype=torch.float64)
    prd = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="nx, ny >= 2"):
        lj_plane_half_force(key, (1, 3, 3), 36, g, g, g, g, prd)
    with pytest.raises(ValueError, match="plane channels"):
        lj_plane_half_fwd(key, (2, 3, 3), 36, g, g, g, g, prd)


def test_kernel_half_table_matches_the_twins():
    """The kernels' half stencil (kHalf in csrc/cell_stencil.cuh, read by
    sorted_grid.cuh's HalfGrid) lists the twin's HALF in its order, which
    is the JAX package's _HALF."""
    text = (SOURCE.parent / "cell_stencil.cuh").read_text()
    body = re.search(r"kHalf\[kHalfBlocks\]\[3\] = \{(.*?)\};", text,
                     re.S).group(1)
    table = [tuple(int(v) for v in row.split(","))
             for row in re.findall(r"\{([^{}]*)\}", body)]
    assert table == HALF == [tuple(o) for o in pp._HALF]
    assert "cell_stencil::kHalf[s]" in (
        SOURCE.parent / "sorted_grid.cuh").read_text()


def test_kernel_pad_constants_match_layout():
    """K8 and P10 tell pads by the sorted layout's sentinel: their source
    includes sorted_grid.cuh, whose kPadPos and kPadStep equal
    ops/sortedforce's."""
    assert '#include "sorted_grid.cuh"' in SOURCE.read_text()
    header = SOURCE.parent / "sorted_grid.cuh"
    consts = dict(re.findall(r"constexpr double (kPad\w+) = ([0-9.e+]+);",
                             header.read_text()))
    assert float(consts["kPadPos"]) == PAD_POS
    assert float(consts["kPadStep"]) == PAD_STEP


@pytest.mark.parametrize("fn", [lj_plane_half_force, lj_plane_half_fwd])
def test_pad_cutoff_raises_off_the_cpu_only(fn):
    """The kernels skip pads on the grounds that no two pads share a cutoff:
    on a tensor off the CPU (meta: no kernel for it) a cutoff of PAD_STEP
    or more raises before any launch, a smaller one reaches the device
    check. The twins skip nothing and take any cutoff: on the all-pad grid
    they find no pair on either side of the bound."""
    ncells, cc = (2, 2, 3), 4
    shape = (*ncells, cc)
    unsafe, safe = ("lj", 48.0, 24.0, PAD_STEP ** 2), (
        "lj", 48.0, 24.0, 0.999 * PAD_STEP ** 2)
    g = torch.zeros(shape, dtype=torch.float64, device="meta")
    prd = torch.ones(3, dtype=torch.float64, device="meta")
    launches = fn.launches
    with pytest.raises(ValueError, match="pad spacing"):
        fn(unsafe, ncells, 48, g, g, g, g, prd)
    with pytest.raises(NotImplementedError, match="device"):
        fn(safe, ncells, 48, g, g, g, g, prd)
    assert fn.launches == launches
    x = torch.from_numpy(np.asarray(PAD_POS + np.arange(48) * PAD_STEP,
                                    dtype=np.float64).reshape(shape))
    ids = torch.full(shape, -1.0, dtype=torch.float64)
    for key in (unsafe, safe):
        f = fn(key, ncells, 48, x, x, x, ids, torch.full((3,), 9.0,
                                                          dtype=torch.float64))
        assert all(torch.equal(a, torch.zeros_like(a)) for a in f)

