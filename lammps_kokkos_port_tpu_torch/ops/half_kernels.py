"""K8, the Newton-half plane force pass, and P10, its forward-only
ablation: CUDA for Hopper, plus their plain twins.

Replaces the JAX package's `plane_half_force_pallas`
(lammps_kokkos_port_tpu/ops/pallas_pair.py:471, kernel `_plane_half_kernel`
:375-459, pallas_call :512) and the forward-only variant of
benchmarks/prof/prof_v3_iso.py (`fwd_call` :77, kernel `fwd_kernel`
:42-74, pallas_call :97). Both walk the 14 blocks of the half stencil
`HALF` over the plane layout `[nx, ny, nz, cc]` with float ids: candidate
ids of blocks s > 0 are offset by `idcap`, and a pair is taken when
`own_id < cand_id` and r2 < cutsq, so each unordered pair of real rows is
evaluated once. K8 adds the reaction -fij to row j; P10 drops it (its
forces are wrong by design, a timing ablation, and it is called only by
`prof.plane_half` and the on-card checks).

`half_walk` is the plain walk of every Newton-half pass of the port: K8
and P10 here, and the column passes of prof/column_half_kernels (P2, P5,
P8, P11), which differ in mask, reciprocal and where the reactions go.

The package's dispatch never reaches K8; its callers are the profiling
entry points (`prof.plane_half`). `lj_plane_half_force` and
`lj_plane_half_fwd` are the entry points: CPU tensors go to the plain
twins, CUDA tensors to `csrc/lj_plane_half.cu` (built with nvcc at first
use, ops/cuda_build) or raise.

The kernels walk the half stencil on the shared candidate walk
(csrc/cell_walk.cuh over sorted_grid.cuh's HalfGrid) and skip pad rows by
their position sentinel, which gives the twins' result only while no pad
lies within the cutoff of another row: on a tensor off the CPU the
wrappers raise on a cutoff of PAD_STEP or more
(`pair_kernels.check_pad_cutoff`); the kernels check the box's part of
the argument themselves.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .pair_kernels import (bind_walk_library, check_grid, check_launch,
                           check_pad_cutoff, stencil, walk_launch)

SOURCE = cuda_build.CSRC / "lj_plane_half.cu"

# _HALF of pallas_pair.py:208-212: the own cell (i < j there) and the 13
# lexicographically positive neighbour offsets
HALF = [(0, 0, 0), (0, 0, 1),
        (0, 1, -1), (0, 1, 0), (0, 1, 1),
        (1, -1, -1), (1, -1, 0), (1, -1, 1),
        (1, 0, -1), (1, 0, 0), (1, 0, 1),
        (1, 1, -1), (1, 1, 0), (1, 1, 1)]
# the distinct (dx, dy) of HALF, the reaction targets of a column, in the
# order of benchmarks/prof/prof_kernel_writeonce.py's _TARGETS (:27)
TARGETS = [(0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]

# ids travel as floats: offset ids stay exact up to the type's integer limit
_ID_LIMIT = {torch.float32: 2 ** 24, torch.float64: 2 ** 53}


def plane_half_fits(ncells) -> bool:
    """K8's grid condition (pallas_pair.plane_half_fits): distinct x and y
    neighbours, and three z cells for the z roll."""
    nx, ny, nz = ncells
    return nx >= 2 and ny >= 2 and nz >= 3


def _flat(ncells, idcap, gx, gy, gz, gi, prd):
    """Validate the [nx, ny, nz, cc] channels and `idcap`; return them as
    [nx*ny*nz, cc] views."""
    if not plane_half_fits(ncells):
        raise ValueError(f"plane-half grid {tuple(ncells)} needs nx, ny >= 2"
                         " and nz >= 3")
    nx, ny, nz = ncells
    if gx.ndim != 4 or tuple(gx.shape[:3]) != (nx, ny, nz):
        raise ValueError(f"plane channels must be [{nx}, {ny}, {nz}, cc], "
                         f"got {tuple(gx.shape)}")
    cc = gx.shape[-1]
    flat = [a.reshape(nx * ny * nz, cc) if a.shape == gx.shape else a
            for a in (gx, gy, gz, gi)]
    check_grid(ncells, flat, prd, min_cells=1)
    check_id_limit(gi, idcap)
    return flat


def check_id_limit(gi, idcap):
    """Float ids offset by `idcap` must stay exact integers of their type."""
    limit = _ID_LIMIT.get(gi.dtype)
    if limit is not None and gi.numel() + idcap > limit:
        raise ValueError(f"ids up to {gi.numel()} + idcap {idcap} exceed "
                         f"{limit}, the last integer {gi.dtype} holds "
                         "exactly")


def half_walk(key, ncells, fl, prd, idcap=0, *, mask="ids", recip="exact",
              react="cell"):
    """The plain half-stencil walk over [nx*ny*nz, cc] channels `fl`
    (x, y, z, and the float ids where the mask reads them).

    mask: "ids": own_id < cand_id, the candidate ids of the 13 neighbour
    blocks offset by `idcap` (K8, P5, P10, P8, P11 fwd); "ids_live": the
    same and own_id >= 0, so a padding row takes no pair (P3); "slot": id-free,
    the self block's candidate slot above the own slot, and 0 < r2 (K1,
    P2); "dist": 0 < r2 only, so the self block takes both orders of each
    pair (P11 fused). The id-free masks clamp r2 at 0.25 before the
    reciprocal, as their TPU bodies do.
    recip: "exact" 1/r2, or "approx": one Newton step y (2 - r2 y) on the
    reciprocal, which stands here for the hardware approximation it refines.
    react: "none": forward sums only; "own": plus the own block's reactions;
    "cell": plus every block's reactions on the candidates' cells; "target":
    forward sums and, apart, rc [nx*ny, 3, nz, 5*cc], each block's
    reactions rolled onto the candidates' z and grouped by (dx, dy) target
    (TARGETS), the layout of prof_kernel_writeonce.py's rc.

    Returns (fx, fy, fz), each [nx, ny, nz, cc], and rc with "target"."""
    _, lj1, lj2, cutsq = key
    nx, ny, nz = ncells
    cc = fl[0].shape[-1]
    dt, dev = fl[0].dtype, fl[0].device
    out = [torch.zeros((nx, ny, nz, cc), dtype=dt, device=dev)
           for _ in range(3)]
    if react == "target":
        rc = torch.zeros((nx, ny, 3, nz, len(TARGETS), cc), dtype=dt,
                         device=dev)
    ids = mask in ("ids", "ids_live")
    if ids:
        own_i = fl[3].reshape(nx, ny, nz, -1)[..., :, None]
    lane = torch.arange(cc, device=dev)
    above = lane[None, :] > lane[:, None]  # [own slot, candidate slot]
    walk = stencil(ncells, *fl[:3], prd, (fl[3],) if ids else (),
                   offsets=HALF)
    for off, (d, r2, _, cand) in zip(HALF, walk):
        if ids:
            ic = cand[0]
            if off != (0, 0, 0):
                ic = torch.where(ic >= 0, ic + idcap, -1.0)
            valid = (own_i < ic[..., None, :]) & (r2 < cutsq)
            if mask == "ids_live":
                valid &= own_i >= 0
            r2s = torch.where(valid, r2, 1.0)
        else:
            valid = (r2 < cutsq) & (r2 > 0)
            if mask == "slot" and off == (0, 0, 0):
                valid &= above
            r2s = torch.clamp(r2, min=0.25)
        r2inv = 1.0 / r2s
        if recip == "approx":
            r2inv = r2inv * (2.0 - r2s * r2inv)
        r6inv = r2inv * r2inv * r2inv
        fpair = torch.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
        for dim in range(3):
            fij = d[dim] * fpair  # [nx, ny, nz, cc own, cc candidate]
            out[dim] += fij.sum(-1)
            if react == "cell" or (react == "own" and off == (0, 0, 0)):
                # -fij lands on the candidate's cell, c + off
                out[dim] -= torch.roll(fij.sum(-2), shifts=off,
                                       dims=(0, 1, 2))
            elif react == "target":
                rc[:, :, dim, :, TARGETS.index(off[:2])] -= torch.roll(
                    fij.sum(-2), shifts=off[2], dims=2)
    if react == "target":
        return tuple(out), rc.reshape(nx * ny, 3, nz, len(TARGETS) * cc)
    return tuple(out)


def lj_plane_half_force_reference(key, ncells, idcap, gx, gy, gz, gi, prd):
    """Plain PyTorch K8: forward sums plus the rolled-back reactions.
    Returns (fx, fy, fz), each [nx, ny, nz, cc]."""
    fl = _flat(ncells, idcap, gx, gy, gz, gi, prd)
    return half_walk(key, ncells, fl, prd, idcap, react="cell")


def lj_plane_half_fwd_reference(key, ncells, idcap, gx, gy, gz, gi, prd):
    """Plain PyTorch P10: K8's forward half sums only."""
    fl = _flat(ncells, idcap, gx, gy, gz, gi, prd)
    return half_walk(key, ncells, fl, prd, idcap, react="none")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    for stem in ("lj_plane_half", "lj_plane_half_fwd"):
        bind_walk_library(lib, stem, 6, 4, 4)
    return lib


def launch_shape(ncells, dtype, react: bool = True) -> dict:
    """The launch K8 (`react`) or P10 makes on the grid `ncells` in
    `dtype` (builds the library)."""
    nx, ny, nz = ncells
    stem = "lj_plane_half" if react else "lj_plane_half_fwd"
    return walk_launch(_library(), stem, nx * ny * nz, dtype)


def output(rows: int, dtype, device, react: bool) -> tuple:
    """The kernels' output for `rows` rows: (buffer, its (fx, fy, fz)
    views of [rows] each). K8 adds every sum into zeros, in f32 an
    interleaved [rows, 4] buffer (x, y, z, unused: one four-wide reduction
    per sum), in f64 three planes [3, rows]; P10 writes [3, rows]."""
    if react and dtype == torch.float32:
        buf = torch.zeros((rows, 4), dtype=dtype, device=device)
        return buf, buf.t()[:3].unbind(0)
    buf = (torch.zeros if react else torch.empty)((3, rows), dtype=dtype,
                                                  device=device)
    return buf, buf.unbind(0)


def _launch(name, key, ncells, idcap, fl, prd, react: bool):
    _, lj1, lj2, cutsq = key
    check_pad_cutoff(cutsq)
    check_launch(fl, prd)
    ncell, cc = fl[0].shape
    dt, dev = fl[0].dtype, fl[0].device
    buf, out = output(ncell * cc, dt, dev, react)
    fn = getattr(_library(),
                 f"{name}_{'f32' if dt == torch.float32 else 'f64'}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a.data_ptr() for a in fl), prd.data_ptr(),
                 buf.data_ptr(), *ncells, cc, float(idcap), lj1, lj2, cutsq,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def lj_plane_half_force(key, ncells, idcap, gx, gy, gz, gi, prd):
    """lj/cut forces of every row of the plane layout, Newton-half.

    key: ("lj", lj1, lj2, cutsq) from PairLJCut.kernel_key(); ncells: the
    (nx, ny, nz) grid (nx, ny >= 2, nz >= 3); idcap: the id offset of the
    13 neighbour blocks (the state capacity, as the JAX callers pass it);
    gx, gy, gz: [nx, ny, nz, cc] positions; gi: [nx, ny, nz, cc] float ids
    (-1 for padding); prd: [3] box lengths. Returns (fx, fy, fz), each
    [nx, ny, nz, cc] (on the card in f32: views of one interleaved
    buffer, `output`). Every launch of the CUDA kernel adds one to
    `lj_plane_half_force.launches`; on a tensor off the CPU a cutoff of
    PAD_STEP or more raises (the kernel's pad skip).
    """
    if key[0] != "lj":
        raise NotImplementedError(f"no plane kernel for style {key[0]!r}")
    fl = _flat(ncells, idcap, gx, gy, gz, gi, prd)
    if gx.device.type == "cpu":
        return lj_plane_half_force_reference(key, ncells, idcap, gx, gy, gz,
                                             gi, prd)
    out = _launch("lj_plane_half", key, ncells, idcap, fl, prd, react=True)
    lj_plane_half_force.launches += 1
    return tuple(a.reshape(gx.shape) for a in out)


def lj_plane_half_fwd(key, ncells, idcap, gx, gy, gz, gi, prd):
    """P10: K8's forward half sums, no reactions (wrong forces by design,
    for timing the reaction path away). Arguments and result as
    `lj_plane_half_force`; every CUDA launch adds one to
    `lj_plane_half_fwd.launches`."""
    if key[0] != "lj":
        raise NotImplementedError(f"no plane kernel for style {key[0]!r}")
    fl = _flat(ncells, idcap, gx, gy, gz, gi, prd)
    if gx.device.type == "cpu":
        return lj_plane_half_fwd_reference(key, ncells, idcap, gx, gy, gz,
                                           gi, prd)
    out = _launch("lj_plane_half_fwd", key, ncells, idcap, fl, prd,
                  react=False)
    lj_plane_half_fwd.launches += 1
    return tuple(a.reshape(gx.shape) for a in out)


lj_plane_half_force.launches = 0
lj_plane_half_fwd.launches = 0
