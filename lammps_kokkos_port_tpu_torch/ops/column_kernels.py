"""K7, the full-stencil column force pass masked by float ids: CUDA for
Hopper, plus its plain twin.

Replaces the JAX package's `column_force_pallas`
(lammps_kokkos_port_tpu/ops/pallas_pair.py:344, kernel `_column_kernel`
:134-198, pallas_call :354): lj/cut forces over the whole 27-cell stencil
of the column layout `[nx*ny, nz, cc]`, the pair of rows i, j skipped when
their float ids are equal (pads carry id -1 and far position sentinels,
ops/sortedforce.PAD_POS, so a pad and a real row die by distance). Periodic
wraps are +-prd shifts of whole neighbour cells, no minimum image. The
package's dispatch never reaches K7; its caller is the sorted-kernel
ablation (`prof.sorted_ablate`, V1).

`lj_column_force` is the entry point. CPU tensors go to the plain PyTorch
version `lj_column_force_reference`; CUDA tensors go to the kernel in
`csrc/lj_column_full.cu`, built with nvcc at first use (ops/cuda_build), or
raise. The kernel is the candidate walk of `lj_cell_force` over packed
(x, y, z, id) records with K7's id rule (csrc/sorted_grid.cuh, IdGrid): it
skips pads at their sentinel, so on a CUDA tensor it raises on a cutoff of
PAD_STEP or more, as the other walk kernels do (`check_pad_cutoff`). Both
shift the candidate across a wrapped face, as JAX K7 does (no frames:
ops/pair_kernels.stencil, frame "candidate").
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .pair_kernels import (check_grid, check_launch, check_pad_cutoff,
                           stencil, walk_launch)

SOURCE = cuda_build.CSRC / "lj_column_full.cu"


def column_channels(ncells, gx, gy, gz, gi, prd):
    """Validate [nx*ny, nz, cc] column channels (positions and float ids)
    and prd; return the channels as [nx*ny*nz, cc] views."""
    nx, ny, nz = ncells
    if gx.ndim != 3 or tuple(gx.shape[:2]) != (nx * ny, nz):
        raise ValueError(f"column channels must be [nx*ny={nx * ny}, nz={nz}"
                         f", cc], got {tuple(gx.shape)}")
    cc = gx.shape[-1]
    flat = [a.reshape(nx * ny * nz, cc) if a.shape == gx.shape else a
            for a in (gx, gy, gz, gi)]
    check_grid(ncells, flat, prd, min_cells=1)
    return flat


def lj_column_force_reference(key, ncells, gx, gy, gz, gi, prd):
    """Plain PyTorch K7: the 27-cell `stencil` walk with K7's id rule.
    Returns (fx, fy, fz), each [nx*ny, nz, cc]."""
    _, lj1, lj2, cutsq = key
    fl = column_channels(ncells, gx, gy, gz, gi, prd)
    nx, ny, nz = ncells
    own_i = fl[3].reshape(nx, ny, nz, -1)[..., :, None]
    out = [torch.zeros_like(a) for a in fl[:3]]
    for d, r2, _, (ic,) in stencil(ncells, *fl[:3], prd, (fl[3],)):
        valid = (own_i != ic[..., None, :]) & (r2 < cutsq)
        r2inv = 1.0 / torch.where(valid, r2, 1.0)
        r6inv = r2inv * r2inv * r2inv
        fpair = torch.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
        for dim in range(3):
            out[dim] += torch.sum(d[dim] * fpair, dim=-1).reshape(
                out[dim].shape)
    return tuple(a.reshape(gx.shape) for a in out)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("lj_column_full_f32", "lj_column_full_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [f64] * 3 + [ptr]
        fn.restype = i32
    lib.lj_column_full_shape.argtypes = [i32, i32, ptr]
    lib.lj_column_full_shape.restype = i32
    return lib


def launch_shape(ncells, dtype) -> dict:
    """The launch K7 (and P6 k1) makes on the grid `ncells` in `dtype`
    (builds the library)."""
    nx, ny, nz = ncells
    return walk_launch(_library(), "lj_column_full", nx * ny * nz, dtype)


def lj_column_force(key, ncells, gx, gy, gz, gi, prd):
    """lj/cut forces of every row of the column layout, K7's rules.

    key: ("lj", lj1, lj2, cutsq) from PairLJCut.kernel_key(); ncells: the
    (nx, ny, nz) grid, each >= 1; gx, gy, gz: [nx*ny, nz, cc] positions;
    gi: [nx*ny, nz, cc] float ids (-1 for padding); prd: [3] box lengths.
    Returns (fx, fy, fz), each [nx*ny, nz, cc]. Every launch of the CUDA
    kernel adds one to `lj_column_force.launches`.
    """
    if key[0] != "lj":
        raise NotImplementedError(f"no column kernel for style {key[0]!r}")
    fl = column_channels(ncells, gx, gy, gz, gi, prd)
    if gx.device.type == "cpu":
        return lj_column_force_reference(key, ncells, gx, gy, gz, gi, prd)
    check_launch(fl, prd)
    ncell, cc = fl[0].shape
    _, lj1, lj2, cutsq = key
    check_pad_cutoff(cutsq)
    out = torch.empty((3,) + tuple(gx.shape), dtype=gx.dtype,
                      device=gx.device)
    fn = (_library().lj_column_full_f32 if gx.dtype == torch.float32
          else _library().lj_column_full_f64)
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = fn(*(a.data_ptr() for a in fl), prd.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                 *ncells, cc, lj1, lj2, cutsq, stream)
    if err != 0:
        raise RuntimeError(f"lj_column_force launch failed: CUDA error {err}")
    lj_column_force.launches += 1
    return out[0], out[1], out[2]


lj_column_force.launches = 0
