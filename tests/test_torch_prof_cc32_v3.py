"""PyTorch port, P3, P4, P6 and P7: the plain twins of the cc 32 and v3
column passes against the Pallas bodies of benchmarks/prof/
prof_kernel_cc32.py and prof_kernel_v3.py in interpret mode on the CPU,
and the two entry points.

The bodies are nested in the scripts' `main`, which builds a 32k-atom
simulation, so they are copied below (`t2_kernel`, `t4_kernel`,
`neighbor_blocks`, `k1_kernel`, `k2_kernel` and their calls), with main's
variables as arguments and `interpret=True`.

Inputs: the JAX sorted state of the 864-atom melt after setup() (grid
(3, 3, 3) x cc 32, cap 864), positions jittered by a seeded +-0.05, six
rows made padding (id -1), five of them at the distinct PAD_POS sentinels
and one 0.84 from a real row of its cell, inside the cutoff. That pad tells
the masks apart: P3 skips a padding own row (own_id >= 0), P5 `full` does
not; P6 skips a padding candidate (cand_id >= 0), K7 does not. Tolerances:
f64 rtol 1e-10 with atol 1e-10*max|f| (the sums run in another order).

P6 k2's twin, `v3_reference(grouped=True)`, is also held against the
copied `k2_kernel` on the grids the column walk is held on beyond the
melt: 1, 2 and 3 cells per dim and cc 64 (lattice grids, pads
interleaved, float ids), f64, at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lammps_kokkos_port_tpu.ops import pallas_pair as pp
from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch.ops.column_kernels import (
    lj_column_force_reference)
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import lj_cell_force
from lammps_kokkos_port_tpu_torch.ops.sortedforce import PAD_POS, PAD_STEP
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
from lammps_kokkos_port_tpu_torch.prof import (
    ablate_kernels as ak,
    column_half_kernels as chk,
    grid,
    kernel_cc32,
    kernel_v3,
    planted,
    v3_kernels,
)

EPS_F64 = 1e-10
NEAR_PAD = 0.84  # the live pad's distance from its real neighbour


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g():
    """Column channels (numpy, f64), ids, key, grid; pads[0] sits inside the
    cutoff of a real row of its own cell."""
    sim = jax_lj_melt_sim(cells=6, t_init=1.44, dtype=jnp.float64, every=20,
                          delay=0, check=False)
    sim.setup()
    st, p = sim.state, sim.nl.params
    valid = np.asarray(st.valid_mask)
    x = np.array(st.x)
    rng = np.random.default_rng(11)
    x[valid] += rng.uniform(-0.05, 0.05, (int(valid.sum()), 3))
    cap, cc = st.capacity, p.cell_cap
    ids = np.where(valid, np.arange(cap), -1).astype(np.float64)
    pads = np.random.default_rng(5).choice(cap, 6, replace=False)
    x[pads] = (PAD_POS + pads * PAD_STEP)[:, None]
    ids[pads] = -1.0
    cell = pads[0] // cc
    real = [r for r in range(cell * cc, (cell + 1) * cc) if ids[r] >= 0]
    x[pads[0]] = x[real[0]] + [NEAR_PAD, 0.0, 0.0]
    nx, ny, nz = p.ncells
    col = (nx * ny, nz, cc)
    return dict(key=sim.pair_style.kernel_key(), ncells=tuple(p.ncells),
                cc=cc, cap=cap, prd=np.array(st.box.prd), pads=pads,
                ids=ids, col=[np.ascontiguousarray(x[:, d].reshape(col))
                              for d in range(3)] + [ids.reshape(col)])


def _jax(g):
    return [jnp.asarray(a) for a in g["col"]], jnp.asarray(g["prd"])


def _torch(g):
    return ([torch.from_numpy(a) for a in g["col"]],
            torch.from_numpy(g["prd"]))


def _assert_close(got, ref, rtol=EPS_F64):
    fmax = max(np.abs(np.asarray(a)).max() for a in ref)
    assert fmax > 1.0  # jittered: the forces are real
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a).reshape(np.shape(b)),
                                   np.asarray(b), rtol=rtol, atol=rtol * fmax)


def _differs(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(a, b)) > 1e-3


def cc32_calls_of(key, ncells, cap, cc, dt, prd, gi):
    """benchmarks/prof/prof_kernel_cc32.py:73-246 (`t2_kernel`, `t2_call`,
    `t4_kernel`, `t4_call`), main's variables as arguments, interpret=True;
    returns {"t2": call, "t4": call}, call(gx, gy, gz)."""
    nx, ny, nz = ncells
    nxy = nx * ny
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    out_shape = [jax.ShapeDtypeStruct((nxy, nz, cc), dt) for _ in range(3)]
    _, lj1, lj2, cutsq = key
    NB = len(pp._HALF)  # 14
    NLANE = NB * cc  # 448

    def t2_kernel(prd_ref, gx_, gy_, gz_, gi_, fx, fy, fz, cand):
        pid = pl.program_id(0)
        nxi, nyi = jnp.int32(nx), jnp.int32(ny)
        cx = pid // nyi
        cy = pid - cx * nyi

        @pl.when(pid == 0)
        def _():
            z = jnp.zeros_like(fx)
            fx[...] = z
            fy[...] = z
            fz[...] = z

        zrow = jax.lax.broadcasted_iota(jnp.int32, (nz, 1), 0)
        cols = sorted({(dx, dy) for dx, dy, _ in pp._HALF})
        ncols = {}
        for dx, dy in cols:
            wx = cx + jnp.int32(dx)
            wy = cy + jnp.int32(dy)
            ncx = jax.lax.rem(wx + nxi, nxi)
            ncy = jax.lax.rem(wy + nyi, nyi)
            sx = jnp.where(wx < 0, -prd_ref[0],
                           jnp.where(wx >= nxi, prd_ref[0], 0.0))
            sy = jnp.where(wy < 0, -prd_ref[1],
                           jnp.where(wy >= nyi, prd_ref[1], 0.0))
            ncols[(dx, dy)] = (ncx * nyi + ncy, sx, sy)

        blocks = [[], [], [], []]  # per component: list of [nz, cc]
        for s, (dx, dy, dz) in enumerate(pp._HALF):
            ncol, sx, sy = ncols[(dx, dy)]
            for ci, (ref, sh) in enumerate(((gx_, sx), (gy_, sy),
                                            (gz_, None), (gi_, None))):
                col = ref[ncol]
                if sh is not None:
                    col = col + sh
                if ci == 3 and s > 0:
                    col = jnp.where(col >= 0.0, col + float(cap), -1.0)
                blk = pltpu.roll(col, (-dz) % nz, axis=0) if dz else col
                if ci == 2 and dz != 0:
                    seam = (zrow == (nz - 1 if dz > 0 else 0))
                    blk = blk + jnp.where(
                        seam, jnp.float32(dz) * prd_ref[2], 0.0
                    ).astype(blk.dtype)
                blocks[ci].append(blk)

        # grouped aligned stores: 4 blocks -> one [nz, 128] tile
        for ci in range(4):
            bl = blocks[ci]
            while len(bl) % 4:
                bl.append(jnp.full((nz, cc), -1.0, dt))
            for t in range(len(bl) // 4):
                tile = jnp.concatenate(bl[4 * t:4 * t + 4], axis=-1)
                cand[ci, :, 128 * t:128 * (t + 1)] = tile

        own_x = gx_[pid][:, :, None]
        own_y = gy_[pid][:, :, None]
        own_z = gz_[pid][:, :, None]
        own_i = gi_[pid][:, :, None]
        dxv = own_x - cand[0][:, None, :]
        dyv = own_y - cand[1][:, None, :]
        dzv = own_z - cand[2][:, None, :]
        r2 = dxv * dxv + dyv * dyv + dzv * dzv
        ic = cand[3]
        valid = jnp.logical_and(
            jnp.logical_and(own_i < ic[:, None, :], own_i >= 0.0),
            r2 < cutsq,
        )
        r2s = jnp.where(valid, r2, 1.0)
        r2inv = 1.0 / r2s
        r6inv = r2inv * r2inv * r2inv
        fpair = jnp.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
        fij_x = dxv * fpair
        fij_y = dyv * fpair
        fij_z = dzv * fpair
        fx[pid] += jnp.sum(fij_x, axis=-1)
        fy[pid] += jnp.sum(fij_y, axis=-1)
        fz[pid] += jnp.sum(fij_z, axis=-1)

        rx = jnp.sum(fij_x, axis=-2)
        ry = jnp.sum(fij_y, axis=-2)
        rz = jnp.sum(fij_z, axis=-2)
        for s, (dx, dy, dz) in enumerate(pp._HALF):
            ncol, _, _ = ncols[(dx, dy)]
            for ref, r in ((fx, rx), (fy, ry), (fz, rz)):
                blk = -r[:, s * cc:(s + 1) * cc]
                if dz:
                    blk = pltpu.roll(blk, dz % nz, axis=0)
                ref[ncol] += blk

    NPAD = ((NLANE + 127) // 128) * 128  # 512

    def t4_kernel(prd_ref, gx_, gy_, gz_, gi_, fx, fy, fz, cand):
        pid = pl.program_id(0)

        @pl.when(pid == 0)
        def _():
            cand[...] = jnp.zeros_like(cand) + 3.0

        own_x = gx_[pid][:, :, None]
        own_y = gy_[pid][:, :, None]
        own_z = gz_[pid][:, :, None]
        own_i = gi_[pid][:, :, None]
        dxv = own_x - cand[0][:, None, :]
        dyv = own_y - cand[1][:, None, :]
        dzv = own_z - cand[2][:, None, :]
        r2 = dxv * dxv + dyv * dyv + dzv * dzv
        ic = cand[3]
        valid = jnp.logical_and(
            jnp.logical_and(own_i < ic[:, None, :], own_i >= 0.0),
            r2 < cutsq,
        )
        r2s = jnp.where(valid, r2, 1.0)
        r2inv = 1.0 / r2s
        r6inv = r2inv * r2inv * r2inv
        fpair = jnp.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
        fx[pid] = jnp.sum(dxv * fpair, axis=-1)
        fy[pid] = jnp.sum(dyv * fpair, axis=-1)
        fz[pid] = jnp.sum(dzv * fpair, axis=-1)

    def make(kern):
        def call(cgx, cgy, cgz):
            return pl.pallas_call(
                kern,
                grid=(nxy,),
                in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [full] * 4,
                out_specs=[full] * 3,
                out_shape=out_shape,
                scratch_shapes=[pltpu.VMEM((4, nz, NPAD), dt)],
                interpret=True,
            )(prd, cgx, cgy, cgz, gi)
        return call

    return {"t2": make(t2_kernel), "t4": make(t4_kernel), "npad": NPAD}


def v3_calls_of(key, ncells, cc, dt, prd, gi):
    """benchmarks/prof/prof_kernel_v3.py:69-198 (`neighbor_blocks`,
    `k1_kernel`, `k2_kernel`, `make`'s call), main's variables as
    arguments, interpret=True; returns {"k1": call, "k2": call}."""
    nx, ny, nz = ncells
    nxy = nx * ny
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    out_shape = [jax.ShapeDtypeStruct((nxy, nz, cc), dt) for _ in range(3)]
    _, lj1, lj2, cutsq = key

    def neighbor_blocks(pid, gx_, gy_, gz_, gi_, prd_ref):
        """Yield (xblk, yblk, zblk, iblk) [nz, cc] for the 27 stencil."""
        nxi, nyi = jnp.int32(nx), jnp.int32(ny)
        cx = pid // nyi
        cy = pid - cx * nyi
        zrow = jax.lax.broadcasted_iota(jnp.int32, (nz, 1), 0)
        for dx in (-1, 0, 1):
            wx = cx + jnp.int32(dx)
            ncx = jax.lax.rem(wx + nxi, nxi)
            sx = jnp.where(wx < 0, -prd_ref[0],
                           jnp.where(wx >= nxi, prd_ref[0], 0.0))
            for dy in (-1, 0, 1):
                wy = cy + jnp.int32(dy)
                ncy = jax.lax.rem(wy + nyi, nyi)
                sy = jnp.where(wy < 0, -prd_ref[1],
                               jnp.where(wy >= nyi, prd_ref[1], 0.0))
                ncol = ncx * nyi + ncy
                colx = gx_[ncol] + sx
                coly = gy_[ncol] + sy
                colz = gz_[ncol]
                coli = gi_[ncol]
                for dz in (-1, 0, 1):
                    bx, by = colx, coly
                    bz = pltpu.roll(colz, (-dz) % nz, axis=0) if dz else colz
                    bi = pltpu.roll(coli, (-dz) % nz, axis=0) if dz else coli
                    if dz:
                        bx = pltpu.roll(colx, (-dz) % nz, axis=0)
                        by = pltpu.roll(coly, (-dz) % nz, axis=0)
                        seam = (zrow == (nz - 1 if dz > 0 else 0))
                        bz = bz + jnp.where(
                            seam, jnp.float32(dz) * prd_ref[2], 0.0
                        ).astype(bz.dtype)
                    yield bx, by, bz, bi

    def k1_kernel(prd_ref, gx_, gy_, gz_, gi_, fx, fy, fz):
        pid = pl.program_id(0)
        bxs, bys, bzs, bis = [], [], [], []
        for bx, by, bz, bi in neighbor_blocks(pid, gx_, gy_, gz_, gi_,
                                              prd_ref):
            bxs.append(bx)
            bys.append(by)
            bzs.append(bz)
            bis.append(bi)
        cx_ = jnp.concatenate(bxs, axis=-1)  # [nz, 27cc]
        cy_ = jnp.concatenate(bys, axis=-1)
        cz_ = jnp.concatenate(bzs, axis=-1)
        ci_ = jnp.concatenate(bis, axis=-1)

        own_x = gx_[pid][:, :, None]
        own_y = gy_[pid][:, :, None]
        own_z = gz_[pid][:, :, None]
        own_i = gi_[pid][:, :, None]
        dxv = own_x - cx_[:, None, :]
        dyv = own_y - cy_[:, None, :]
        dzv = own_z - cz_[:, None, :]
        r2 = dxv * dxv + dyv * dyv + dzv * dzv
        valid = jnp.logical_and(
            jnp.logical_and(own_i != ci_[:, None, :],
                            (ci_ >= 0.0)[:, None, :]),
            r2 < cutsq,
        )
        r2s = jnp.where(valid, r2, 1.0)
        r2inv = 1.0 / r2s
        r6inv = r2inv * r2inv * r2inv
        fpair = jnp.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
        fx[pid] = jnp.sum(dxv * fpair, axis=-1)
        fy[pid] = jnp.sum(dyv * fpair, axis=-1)
        fz[pid] = jnp.sum(dzv * fpair, axis=-1)

    def k2_kernel(prd_ref, gx_, gy_, gz_, gi_, fx, fy, fz):
        pid = pl.program_id(0)
        own_x = gx_[pid][:, :, None]
        own_y = gy_[pid][:, :, None]
        own_z = gz_[pid][:, :, None]
        own_i = gi_[pid][:, :, None]
        accx = jnp.zeros((nz, cc), dt)
        accy = jnp.zeros((nz, cc), dt)
        accz = jnp.zeros((nz, cc), dt)
        blocks = list(neighbor_blocks(pid, gx_, gy_, gz_, gi_, prd_ref))
        for s in range(0, 27, 3):
            bx = jnp.concatenate([blocks[s][0], blocks[s+1][0],
                                  blocks[s+2][0]], axis=-1)
            by = jnp.concatenate([blocks[s][1], blocks[s+1][1],
                                  blocks[s+2][1]], axis=-1)
            bz = jnp.concatenate([blocks[s][2], blocks[s+1][2],
                                  blocks[s+2][2]], axis=-1)
            bi = jnp.concatenate([blocks[s][3], blocks[s+1][3],
                                  blocks[s+2][3]], axis=-1)
            dxv = own_x - bx[:, None, :]
            dyv = own_y - by[:, None, :]
            dzv = own_z - bz[:, None, :]
            r2 = dxv * dxv + dyv * dyv + dzv * dzv
            valid = jnp.logical_and(
                jnp.logical_and(own_i != bi[:, None, :],
                                (bi >= 0.0)[:, None, :]),
                r2 < cutsq,
            )
            r2s = jnp.where(valid, r2, 1.0)
            r2inv = 1.0 / r2s
            r6inv = r2inv * r2inv * r2inv
            fpair = jnp.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv,
                              0.0)
            accx = accx + jnp.sum(dxv * fpair, axis=-1)
            accy = accy + jnp.sum(dyv * fpair, axis=-1)
            accz = accz + jnp.sum(dzv * fpair, axis=-1)
        fx[pid] = accx
        fy[pid] = accy
        fz[pid] = accz

    def make(kern):
        def call(cgx, cgy, cgz):
            return pl.pallas_call(
                kern,
                grid=(nxy,),
                in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [full] * 4,
                out_specs=[full] * 3,
                out_shape=out_shape,
                interpret=True,
            )(prd, cgx, cgy, cgz, gi)
        return call

    return {"k1": make(k1_kernel), "k2": make(k2_kernel)}


@pytest.fixture(scope="module")
def cc32(g):
    (gx, gy, gz, gi), prd = _jax(g)
    return cc32_calls_of(g["key"], g["ncells"], g["cap"], g["cc"],
                         jnp.float64, prd, gi)


@pytest.fixture(scope="module")
def v3(g):
    (gx, gy, gz, gi), prd = _jax(g)
    return v3_calls_of(g["key"], g["ncells"], g["cc"], jnp.float64, prd, gi)


def test_p3_twin_matches_t2_and_keeps_its_mask(g, cc32):
    (gx, gy, gz, _), _ = _jax(g)
    ref = cc32["t2"](gx, gy, gz)
    (tx, ty, tz, ti), prd = _torch(g)
    args = (g["key"], g["ncells"], g["cap"], tx, ty, tz, ti, prd)
    got = chk.reference("cc32_half", *args)
    launches = chk.cc32_half.launches
    assert all(torch.equal(a, b) for a, b in zip(chk.cc32_half(*args), got))
    assert chk.cc32_half.launches == launches  # CPU: the plain twin
    _assert_close(got, ref)
    # the live pad takes no pair under P3's mask; P5 full's gives it one
    pad = g["pads"][0]
    assert all(float(a.reshape(-1)[pad]) == 0.0 for a in got)
    assert _differs(got, chk.reference("iso_full", *args))


def test_p4_twin_matches_t4_and_counts_512_lanes(cc32):
    """T4 on inputs where its pair math is live (positions 3 +- [0.8, 1.2]
    per axis, ids -1..4: the melt has no row near the constant
    candidate)."""
    assert cc32["npad"] == 512
    ncells, cc = (3, 3, 3), 32
    rng = np.random.default_rng(4)
    shape = (9, 3, cc)
    x = [3.0 + rng.choice([-1, 1], shape) * rng.uniform(0.8, 1.2, shape)
         for _ in range(3)]
    gi = rng.integers(-1, 5, shape).astype(np.float64)
    prd = np.full(3, 7.0)
    key = ("lj", 48.0, 24.0, 6.25)
    ref = cc32_calls_of(key, ncells, 864, cc, jnp.float64, jnp.asarray(prd),
                        jnp.asarray(gi))["t4"](*(jnp.asarray(a) for a in x))
    args = [torch.from_numpy(a) for a in (*x, gi, prd)]
    got = ak.pair_only(key, ncells, *args, lanes=512)
    _assert_close(got, ref)
    # a kept row sums one term per lane: 512 of them, not P9's 14*cc = 448
    p9 = ak.pair_only(key, ncells, *args)
    np.testing.assert_allclose(got[0].numpy(), p9[0].numpy() * 512 / 448,
                               rtol=1e-12, atol=1e-12)
    assert _differs(got, p9)
    with pytest.raises(ValueError, match="lanes"):
        ak.pair_only(key, ncells, *args, lanes=0)


@pytest.mark.parametrize("name", ["k1", "k2"])
def test_p6_twins_match_the_bodies_and_keep_their_mask(g, v3, name):
    (gx, gy, gz, _), _ = _jax(g)
    ref = v3[name](gx, gy, gz)
    (tx, ty, tz, ti), prd = _torch(g)
    args = (g["key"], g["ncells"], tx, ty, tz, ti, prd)
    fn = getattr(v3_kernels, f"v3_{name}")
    launches = fn.launches
    got = fn(*args)
    assert fn.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(
        got, v3_kernels.v3_reference(*args, grouped=name == "k2")))
    _assert_close(got, ref)
    # K7 takes the live pad as a candidate; k1 and k2 skip it
    assert _differs(got, lj_column_force_reference(*args))


def test_p7_is_k1_against_the_shipped_kernel(g, v3):
    """P7's parity line: k1 against the shipped kernel. On inputs without a
    pad inside the cutoff both are the full stencil's forces."""
    col = [a.copy() for a in g["col"]]
    pad = g["pads"][0]
    for d in range(3):
        col[d].reshape(-1)[pad] = PAD_POS + pad * PAD_STEP
    (tx, ty, tz, ti), prd = [torch.from_numpy(a) for a in col], \
        torch.from_numpy(g["prd"])
    k1 = v3_kernels.v3_k1(g["key"], g["ncells"], tx, ty, tz, ti, prd)
    k2 = v3_kernels.v3_k2(g["key"], g["ncells"], tx, ty, tz, ti, prd)
    shipped = lj_cell_force(g["key"], g["ncells"],
                            *(a.reshape(-1, g["cc"]) for a in (tx, ty, tz)),
                            prd)
    _assert_close(k1, [a.reshape(k1[0].shape) for a in shipped])
    _assert_close(k2, k1)
    ref = v3["k1"](*(jnp.asarray(a) for a in col[:3]))
    _assert_close(k1, ref)


def test_resort_keeps_the_grid_and_raises_on_overflow():
    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64, every=20,
                      delay=0, check=False, device="cpu")
    sim.setup()
    assert sim.nl.params.cell_cap == 32
    sp, re = grid.sorted_planes(sim), grid.sorted_planes(sim, cell_cap=32)
    assert (re.ncells, re.cc, re.cap) == (sp.ncells, sp.cc, sp.cap)
    torch.testing.assert_close(re.buf, sp.buf, rtol=0, atol=0)
    # in f32 the lattice start bins 33 atoms into some of the 27 cells:
    # room for every atom (27 * 32 = 864 rows), but a cell overflows
    sim32 = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float32, every=20,
                        delay=0, check=False, device="cpu")
    sim32.setup()
    with pytest.raises(RuntimeError, match="cell_cap 32 overflowed"):
        grid.resort(sim32, 32)


CC32_LABELS = ["natoms=", "T1 shipped@32 :", "T2 aligned    :",
               "T2 vs shipped fx: rel err", "T2 vs shipped fy: rel err",
               "T2 vs shipped fz: rel err", "T4 pair floor :"]
V3_LABELS = ["natoms=", "K1 full27 concat :", "K2 col-group acc :",
             "K1 vs shipped fx: rel err", "K1 vs shipped fy: rel err",
             "K1 vs shipped fz: rel err"]


def test_entry_points_print_every_label(capsys):
    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64, every=20,
                      delay=0, check=False, device="cpu")
    sim.setup()
    for mod, labels in ((kernel_cc32, CC32_LABELS), (kernel_v3, V3_LABELS)):
        if mod is kernel_v3:
            # off the lattice, where the forces stand above their rounding:
            # at setup they are zeros to 5e-14, which k1 (K7's frame) and
            # the shipped kernel (K1's frame, ROADMAP F12) round apart
            sim.run(10)
        res = mod.main(device="cpu", k1=1, k2=2, sim=sim)
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith("device: cpu")
        for label in labels:
            assert sum(ln.startswith(label) for ln in lines) == 1, label
        assert all(np.isfinite(v) for v in res.values())
    # k1 on the melt (no pad in the cutoff): the shipped forces
    assert max(res[f"K1 vs shipped f{n}"] for n in "xyz") < 1e-9
    # cells 6 in f32 overflows cc 32 (33 atoms in a cell): the run raises
    with pytest.raises(RuntimeError, match="overflowed"):
        kernel_cc32.main(cells=6, device="cpu", k1=1, k2=2)


# P6 k2's twin on the grids the column walk is held on beyond the melt: 1,
# 2 and 3 cells per dim and cc 64 (lattice grids, pads interleaved, float
# ids), f64, rtol 1e-10 with atol 1e-10*max: the sums run in another order
KEY = ("lj", 48.0, 24.0, 6.25)
EDGE_GRIDS = [((1, 1, 1), 16), ((2, 2, 4), 32), ((3, 3, 3), 32),
              ((3, 3, 4), 64)]


def _edge_grid(ncells, cc):
    """A lattice grid (jittered atoms at random lanes among pads, float
    ids) as the column walk's tests build it, f64: ([gx, gy, gz, gi], prd)."""
    ncell = ncells[0] * ncells[1] * ncells[2]
    counts = [(c * 5) % (min(cc, 32) // 2) + 2 for c in range(ncell)]
    if cc > 32:
        counts[ncell // 2] = 40  # two row passes of one warp
    g, prd, valid = planted.lattice_grid(ncells, cc, counts, 5,
                                         torch.float64, "cpu")
    ids = torch.where(valid, torch.arange(valid.numel()).reshape(
        valid.shape), -1).to(torch.float64)
    shape = (ncells[0] * ncells[1], ncells[2], cc)
    col = [a.reshape(shape) for a in (*g, ids)]
    return col, prd


@pytest.mark.parametrize("ncells,cc", EDGE_GRIDS)
def test_k2_twin_matches_the_script_body_on_edge_grids(ncells, cc):
    col, prd = _edge_grid(ncells, cc)
    calls = v3_calls_of(KEY, ncells, cc, jnp.float64,
                        jnp.asarray(prd.numpy()), jnp.asarray(col[3].numpy()))
    ref = [torch.from_numpy(np.array(a)) for a in
           calls["k2"](*(jnp.asarray(a.numpy()) for a in col[:3]))]
    args = (KEY, ncells, *col, prd)
    twin = v3_kernels.v3_reference(*args, grouped=True)
    launches = v3_kernels.v3_k2.launches
    got = v3_kernels.v3_k2(*args)
    assert v3_kernels.v3_k2.launches == launches  # CPU: the plain twin
    assert all(torch.equal(a, b) for a, b in zip(got, twin))
    vmax = max(a.abs().max().item() for a in ref)
    assert vmax > 0.01  # pairs within the cutoff
    for a, b in zip(twin, ref):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * vmax)
    # the same forces as k1, summed in another order
    for a, b in zip(twin, v3_kernels.v3_reference(*args)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * vmax)
