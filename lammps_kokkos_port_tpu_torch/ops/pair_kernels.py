"""The lj/cut cell force kernel: CUDA for Hopper, plus its plain twin.

Replaces the three Pallas TPU kernels of the JAX package's sorted path,
which compute the same forces and differ only in how they tile TPU memory:
`column_half_force_pallas` (lammps_kokkos_port_tpu/ops/pallas_pair.py:319),
`slab_half_force_pallas` (:659) and `plane_force_pallas` (:811). One kernel
serves every grid size, so the port has no column/slab dispatch.

`lj_cell_force` is the entry point. CPU tensors go to the plain PyTorch
version `lj_cell_force_reference` (the CPU tests use it); CUDA tensors go
to the kernel in `csrc/lj_cell_force.cu`, which is built with nvcc at first
use into `_build/` and bound with ctypes (ops/cuda_build). There is no
fallback from a CUDA tensor to the plain version: the wrapper launches the
kernel or raises.

`compute_sorted` is lj/cut's force path on the sorted layout (the
style's "sorted" mode, models/pair_lj): the kernel on every step, the
plain grid path of ops/gridforce on thermo rows. `tally_sums` reduces the
per-row energy and virial planes of the EAM and Tersoff tally kernels.

Each pair is formed in the frame of the Newton-half K1/K2 (`stencil`,
frame "half"): across a wrapped face both rows of a pair at the cutoff
take K1's one decision (tests/test_torch_cutoff_frame.py).

The kernel skips pad rows (their position sentinel, ops/sortedforce.py)
instead of walking them, which gives the plain version's result only while
no pad lies within the cutoff of another row: on a CUDA tensor
`lj_cell_force` raises on a cutoff of PAD_STEP or more
(`check_pad_cutoff`); the kernel checks the box's part of the argument
itself (csrc/sorted_grid.cuh).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build, gridforce
from .sortedforce import PAD_STEP, planar

SOURCE = cuda_build.CSRC / "lj_cell_force.cu"
# the cell_stencil.cuh sweep kernels: one thread per row, one block row per
# cell (lj_cell_force itself runs any cell_cap in row passes of one warp)
MAX_CELL_CAP = 1024

_OFFSETS = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
            for oz in (-1, 0, 1)]


def check_grid(ncells, channels, prd, min_cells: int = 3):
    """Validate a cell kernel's inputs: [nx*ny*nz, cc] channels of one
    dtype and device on a grid of >= `min_cells` cells per dim, and a [3]
    prd."""
    nx, ny, nz = ncells
    if min(nx, ny, nz) < min_cells:
        # with fewer than 3 cells a dim's -1 and +1 neighbours coincide and
        # the 27-cell stencil would count a pair twice
        raise ValueError(f"cell grid {tuple(ncells)} needs >= {min_cells} "
                         "cells per dim")
    g0 = channels[0]
    shape = g0.shape
    if len(shape) != 2 or shape[0] != nx * ny * nz:
        raise ValueError(f"grid tensors must be [ncells={nx * ny * nz}, cc]"
                         f", got {tuple(shape)}")
    for a in channels[1:]:
        if a.shape != shape or a.dtype != g0.dtype or a.device != g0.device:
            raise ValueError("grid channels must share shape, dtype and "
                             "device")
    if prd.shape != (3,) or prd.dtype != g0.dtype or prd.device != g0.device:
        raise ValueError("prd must be a [3] tensor of the grid's dtype and "
                         "device")


def check_launch(channels, prd):
    """What the CUDA cell kernels take beyond check_grid: a CUDA device,
    f32 or f64, contiguous tensors, cell_cap <= MAX_CELL_CAP."""
    g0 = channels[0]
    if g0.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {g0.device}")
    if g0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {g0.dtype}")
    if not all(a.is_contiguous() for a in (*channels, prd)):
        raise ValueError("kernel inputs must be contiguous")
    if g0.shape[1] > MAX_CELL_CAP:
        raise ValueError(f"cell_cap {g0.shape[1]} > {MAX_CELL_CAP}")


def mirrored(off) -> bool:
    """Whether a stencil offset's first nonzero component is negative: the
    mirror of an entry of the Newton-half stencil (the own cell and the 13
    lexicographically positive offsets, JAX `_HALF`)."""
    return next((o for o in off if o), 0) < 0


def stencil(ncells, gx, gy, gz, prd, extra=(), offsets=_OFFSETS,
            frame="candidate"):
    """The stencil walk of the plain twins, over the 27 neighbour offsets
    or the given `offsets`. For each offset the grid is rolled so that
    cell c faces cell c+offset; cells whose neighbour wraps across the box
    get an explicit +-prd shift (no minimum image). Yields (d, r2, pair_ok,
    cand) per offset: d = [dx, dy, dz] own minus candidate, each [nx, ny,
    nz, cc, cc]; r2 = dx*dx + dy*dy + dz*dz (each product and sum rounded,
    as the kernels round it); pair_ok masks the self pair (lane index in the
    own cell); cand = the `extra` channels rolled alike, [nx, ny, nz, cc].

    `frame` "candidate": d = own - (cand + shift) at every offset, as the
    full-stencil kernels K3 and K7 form it. "half": at a `mirrored` offset
    d = (own - shift) - cand, exactly minus the d that the Newton-half
    kernels K1/K2 form once for the pair from the other cell, so both rows
    take K1's cutoff decision (csrc/sorted_grid.cuh, FramedGrid)."""
    if frame not in ("candidate", "half"):
        raise ValueError(f"frame must be 'candidate' or 'half', got {frame!r}")
    nx, ny, nz = ncells
    cc = gx.shape[-1]
    dev = gx.device
    own = [a.reshape(nx, ny, nz, cc) for a in (gx, gy, gz)]
    lane = torch.arange(cc, device=dev)
    not_self = lane[:, None] != lane[None, :]
    for off in offsets:
        shifts = (-off[0], -off[1], -off[2])
        moved = frame == "half" and mirrored(off)
        d = []
        for dim, n in enumerate(ncells):
            cand = torch.roll(own[dim], shifts=shifts, dims=(0, 1, 2))
            w = torch.arange(n, device=dev) + off[dim]
            shift = torch.where(w < 0, -prd[dim],
                                torch.where(w >= n, prd[dim], 0.0))
            view = [1, 1, 1, 1]
            view[dim] = n
            if moved:
                d.append((own[dim] - shift.reshape(view))[..., :, None]
                         - cand[..., None, :])
            else:
                cand = cand + shift.reshape(view)
                d.append(own[dim][..., :, None] - cand[..., None, :])
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]  # [nx,ny,nz,cc,cc]
        pair_ok = not_self if off == (0, 0, 0) else None
        cand = [torch.roll(a.reshape(nx, ny, nz, cc), shifts=shifts,
                           dims=(0, 1, 2)) for a in extra]
        yield d, r2, pair_ok, cand


def tally_sums(tally, valid):
    """A tally's 7 planes [7, ...] summed over the rows where `valid` (one
    entry per row) is set, in float64: (pe, virial xx, yy, zz, xy, xz,
    yz). Pad rows are left out: where the walks cannot tell pads by
    position (csrc/sorted_grid.cuh), pads that meet get a pair energy and
    a virial of their own, which the grid-roll path masks too."""
    return torch.where(valid, tally.reshape(7, -1), 0.0).sum(
        dim=1, dtype=torch.float64)


def lj_cell_force_reference(key, ncells, gx, gy, gz, prd):
    """Plain PyTorch lj/cut force-only pass over the cell-major grid (the
    27-cell `stencil` walk, each pair in K1's frame). Returns [3, ncells,
    cc] (fx, fy, fz stacked on the leading axis)."""
    _, lj1, lj2, cutsq = key
    out = [torch.zeros_like(a) for a in (gx, gy, gz)]
    for d, r2, pair_ok, _ in stencil(ncells, gx, gy, gz, prd, frame="half"):
        valid = r2 < cutsq
        if pair_ok is not None:
            valid = valid & pair_ok
        r2inv = 1.0 / torch.where(valid, r2, 1.0)
        r6inv = r2inv * r2inv * r2inv
        fpair = torch.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
        for dim in range(3):
            out[dim] += torch.sum(d[dim] * fpair, dim=-1).reshape(
                out[dim].shape)
    return torch.stack(out)


def check_pad_cutoff(cutsq: float) -> None:
    """The sorted-layout kernels' pad skip (lj_cell_force, the two EAM
    sweeps) is exact only while no pad lies within the cutoff of another
    pad, in any frame the stencil shifts a candidate into. In a frame where
    one axis is not shifted, two pads differ by a nonzero multiple of
    PAD_STEP in that axis, so a cutoff below PAD_STEP keeps them apart; the
    frames shifted in all three axes and the real rows are the box's part
    of the argument, which the kernels check on the card
    (csrc/sorted_grid.cuh), walking every row as the plain
    version does where it fails. The plain version skips nothing and
    needs no such check."""
    if not cutsq < PAD_STEP ** 2:
        raise ValueError(f"cell kernel: cutoff {cutsq ** 0.5:g} >= the "
                         f"pad spacing {PAD_STEP:g} of the sorted layout")


def bind_walk_library(lib: ctypes.CDLL, stem: str, npointers: int,
                      nints: int, nfloats: int) -> ctypes.CDLL:
    """Set the ctypes signatures of a cell_walk.cuh kernel library:
    `<stem>_f32` and `<stem>_f64` (pointers, ints, doubles, the stream) and
    `<stem>_shape` (ncell, f64, int out[4])."""
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in (f"{stem}_f32", f"{stem}_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * npointers + [i32] * nints + [f64] * nfloats + [
            ptr]
        fn.restype = i32
    shape = getattr(lib, f"{stem}_shape")
    shape.argtypes = [i32, i32, ptr]
    shape.restype = i32
    return lib


def walk_launch(lib: ctypes.CDLL, stem: str, ncell: int, dtype) -> dict:
    """The launch a cell_walk.cuh kernel makes on `ncell` cells in `dtype`,
    as the library computes it: blocks, threads per block, dynamic shared
    memory bytes."""
    out = (ctypes.c_int * 4)()
    getattr(lib, f"{stem}_shape")(ncell, int(dtype == torch.float64), out)
    return {"blocks": out[0], "threads": (out[1], out[2]),
            "smem_bytes": out[3]}


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    return bind_walk_library(cuda_build.load(SOURCE), "lj_cell_force", 7, 4,
                             3)


def launch_shape(ncells, dtype) -> dict:
    """The launch `lj_cell_force` makes on the grid `ncells` in `dtype`
    (builds the library)."""
    nx, ny, nz = ncells
    return walk_launch(_library(), "lj_cell_force", nx * ny * nz, dtype)


def lj_cell_force(key, ncells, gx, gy, gz, prd):
    """lj/cut forces on every row of the cell-major grid.

    key: ("lj", lj1, lj2, cutsq) from PairLJCut.kernel_key(); ncells: the
    (nx, ny, nz) grid, each >= 3; gx, gy, gz: [nx*ny*nz, cc] positions with
    cell id (cx*ny+cy)*nz+cz; prd: [3] box lengths. Returns [3, ncells, cc]
    (fx, fy, fz on the leading axis). Every launch of the CUDA kernel adds
    one to `lj_cell_force.launches`.
    """
    if key[0] != "lj":
        raise NotImplementedError(f"no cell kernel for style {key[0]!r}")
    check_grid(ncells, (gx, gy, gz), prd)
    if gx.device.type == "cpu":
        return lj_cell_force_reference(key, ncells, gx, gy, gz, prd)
    check_launch((gx, gy, gz), prd)
    _, lj1, lj2, cutsq = key
    check_pad_cutoff(cutsq)
    ncell, cc = gx.shape
    out = torch.empty((3, ncell, cc), dtype=gx.dtype, device=gx.device)
    fn = (_library().lj_cell_force_f32 if gx.dtype == torch.float32
          else _library().lj_cell_force_f64)
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = fn(gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), prd.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                 *ncells, cc, lj1, lj2, cutsq, stream)
    if err != 0:
        raise RuntimeError(f"lj_cell_force launch failed: CUDA error {err}")
    lj_cell_force.launches += 1
    return out


lj_cell_force.launches = 0


def compute_sorted(style, state, cl, eflag: bool, vflag: bool):
    """lj/cut's (f, pe, virial) on a SortedCells state, one atom type (the
    style's "sorted" path, models/pair_lj). The force-only pass (every MD
    step) goes through `lj_cell_force`; energy/virial passes (thermo rows)
    take the plain PyTorch grid path (ops/gridforce) on the identity
    buckets the sorted layout implies, as the JAX package took its XLA
    path there. pe and virial are None unless asked for."""
    p = cl.params
    cap = state.capacity
    ntot = p.total_cells
    cc = p.cell_cap

    if not eflag and not vflag:
        g = planar(state.x).reshape(3, ntot, cc)
        f = lj_cell_force(style.kernel_key(), p.ncells, g[0], g[1], g[2],
                          state.box.prd.to(state.dtype))
        return f.reshape(3, cap).t().contiguous(), None, None

    rows = torch.arange(cap, dtype=torch.int32,
                        device=state.device).reshape(ntot, cc)
    buckets = torch.where(state.mask.reshape(ntot, cc) != 0, rows, cap)
    buckets = torch.cat(
        [buckets, torch.full((1, cc), cap, dtype=torch.int32,
                             device=state.device)], dim=0)
    gc = gridforce.GridCells(buckets=buckets, params=p)
    return gridforce.compute(style, state, gc, eflag, vflag)
