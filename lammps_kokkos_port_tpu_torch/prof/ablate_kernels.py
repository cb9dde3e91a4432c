"""P9 and P4, the timing ablations of the sorted lj/cut pass: CUDA for
Hopper, plus their plain twins.

Replaces the three Pallas bodies that benchmarks/prof/prof_sorted_ablate.py
launches through its one call site (`make_call` :169-183, pallas_call
:171) on the column layout `[nx*ny, nz, cc]`:

  `asm_only`          (asm_only_kernel :96-130): assemble the 14 half-
                      stencil candidate blocks, write the own block's
                      (x + y, z, id);
  `pair_only`         (pair_only_kernel :132-167, exact reciprocal): the pair
                      math of 14*cc candidates per row against a constant
                      candidate scratch of 3.0 in every channel, a pair valid
                      where 0 <= own_id < 3.0 and r2 < cutsq;
  `pair_only_approx`  the same with the hardware approximate reciprocal,
                      float32 only (as the script runs it);

and P4, benchmarks/prof/prof_kernel_cc32.py's `t4_call` (:238-246, kernel
`t4_kernel` :210-236, pallas_call :239): `pair_only` over NPAD = 512
candidate lanes (:179) in place of 14*cc, `pair_only(..., lanes=512)`.

They measure parts of a kernel and their outputs are not forces. Their
callers are `prof.sorted_ablate` (V2-V4) and `prof.kernel_cc32` (T4). CPU
tensors go to the plain twins; CUDA tensors go to `csrc/lj_ablate.cu`
(ops/cuda_build) or raise. Each wrapper counts its CUDA launches in
`.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import cuda_build
from ..ops.column_kernels import column_channels
from ..ops.half_kernels import HALF
from ..ops.pair_kernels import check_launch

SOURCE = cuda_build.CSRC / "lj_ablate.cu"
FILL = 3.0  # the constant candidate scratch of pair_only_kernel (:140)
# shared memory: 14 blocks x 4 channels x cc per cell row of a block
MAX_CELL_CAP = 256
MAX_LANES = 2048  # pair_only's constant candidates: 4 channels in shared


def _check_cuda(flat, prd):
    check_launch(flat, prd)
    if flat[0].shape[1] > MAX_CELL_CAP:
        raise ValueError(f"cell_cap {flat[0].shape[1]} > {MAX_CELL_CAP}")


def asm_only_reference(ncells, gx, gy, gz, gi, prd):
    """What asm_only writes: the own block (stencil block 0, no shift) as
    (x + y, z, id)."""
    column_channels(ncells, gx, gy, gz, gi, prd)
    return gx + gy, gz.clone(), gi.clone()


def _lanes(lanes, gx):
    """The candidate lanes of a row: 14*cc unless given (P4: 512)."""
    lanes = len(HALF) * gx.shape[-1] if lanes is None else int(lanes)
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"lanes must be in [1, {MAX_LANES}], got {lanes}")
    return lanes


def pair_only_reference(key, ncells, gx, gy, gz, gi, prd, lanes=None):
    """What pair_only writes: for each row the `lanes` (default 14*cc)
    identical terms of the constant candidate (FILL in x, y, z and id),
    summed. Also the twin of pair_only_approx, whose reciprocal is within 2
    ulp of the exact one."""
    _, lj1, lj2, cutsq = key
    column_channels(ncells, gx, gy, gz, gi, prd)
    n = _lanes(lanes, gx)
    d = [a - FILL for a in (gx, gy, gz)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    valid = (gi < FILL) & (gi >= 0) & (r2 < cutsq)
    r2inv = 1.0 / torch.where(valid, r2, 1.0)
    r6inv = r2inv * r2inv * r2inv
    fpair = torch.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
    return tuple((a * fpair)[..., None].expand(*a.shape, n).sum(-1)
                 for a in d)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("lj_asm_only_f32", "lj_asm_only_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        fn.restype = i32
    for name in ("lj_pair_only_f32", "lj_pair_only_f64",
                 "lj_pair_only_approx_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 7 + [i32] * 3 + [f64] * 4 + [ptr]
        fn.restype = i32
    return lib


def _suffix(t: torch.Tensor) -> str:
    return "f32" if t.dtype == torch.float32 else "f64"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def asm_only(ncells, gx, gy, gz, gi, prd):
    """V2: stage the 14 candidate blocks of every cell, write the own
    block's (x + y, z, id). gx, gy, gz, gi: [nx*ny, nz, cc]; prd: [3].
    Returns three [nx*ny, nz, cc] tensors."""
    fl = column_channels(ncells, gx, gy, gz, gi, prd)
    if gx.device.type == "cpu":
        return asm_only_reference(ncells, gx, gy, gz, gi, prd)
    _check_cuda(fl, prd)
    out = torch.empty((3,) + tuple(gx.shape), dtype=gx.dtype,
                      device=gx.device)
    fn = getattr(_library(), f"lj_asm_only_{_suffix(gx)}")
    with torch.cuda.device(gx.device):
        err = fn(*(a.data_ptr() for a in fl), prd.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                 *ncells, fl[0].shape[1], _stream(gx))
    if err != 0:
        raise RuntimeError(f"asm_only launch failed: CUDA error {err}")
    asm_only.launches += 1
    return out[0], out[1], out[2]


def _pair(name, key, ncells, gx, gy, gz, gi, prd, lanes):
    fl = column_channels(ncells, gx, gy, gz, gi, prd)
    _check_cuda(fl, prd)
    lanes = _lanes(lanes, gx)
    _, lj1, lj2, cutsq = key
    ncell, cc = fl[0].shape
    out = torch.empty((3,) + tuple(gx.shape), dtype=gx.dtype,
                      device=gx.device)
    fn = getattr(_library(), f"{name}_{_suffix(gx)}")
    with torch.cuda.device(gx.device):
        err = fn(*(a.data_ptr() for a in fl), out[0].data_ptr(),
                 out[1].data_ptr(), out[2].data_ptr(), ncell, cc, lanes,
                 FILL, lj1, lj2, cutsq, _stream(gx))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out[0], out[1], out[2]


def pair_only(key, ncells, gx, gy, gz, gi, prd, lanes=None):
    """V3 (and T4 with lanes=512): the pair math against the constant
    candidate scratch, exact reciprocal, over `lanes` candidates per row
    (default 14*cc). Arguments as `asm_only` (prd is checked and unused, as
    in the scripts' calls); returns three [nx*ny, nz, cc]."""
    if gx.device.type == "cpu":
        return pair_only_reference(key, ncells, gx, gy, gz, gi, prd, lanes)
    out = _pair("lj_pair_only", key, ncells, gx, gy, gz, gi, prd, lanes)
    pair_only.launches += 1
    return out


def pair_only_approx(key, ncells, gx, gy, gz, gi, prd):
    """V4: `pair_only` with the hardware approximate reciprocal
    (rcp.approx.ftz.f32), float32 only. On the CPU the exact twin."""
    if gx.dtype != torch.float32:
        raise TypeError(f"pair_only_approx takes float32, got {gx.dtype}")
    if gx.device.type == "cpu":
        return pair_only_reference(key, ncells, gx, gy, gz, gi, prd)
    out = _pair("lj_pair_only_approx", key, ncells, gx, gy, gz, gi, prd,
                None)
    pair_only_approx.launches += 1
    return out


asm_only.launches = 0
pair_only.launches = 0
pair_only_approx.launches = 0
