"""P6 and P7, the full-stencil column passes of prof_kernel_v3.py: CUDA for
Hopper, plus their plain twins.

Replaces the Pallas bodies that benchmarks/prof/prof_kernel_v3.py launches
through `make(kern)` -> `call` (:185-198, pallas_call :187), on the column
layout `[nx*ny, nz, cc]`:

  `v3_k1`  k1_kernel (:109-142): lj/cut over the 27-cell stencil (K7's
           forces, ops/column_kernels.lj_column_force) with one more test,
           a candidate is taken only when its float id is >= 0
           (:131-134), so a padding row never acts on a real row wherever
           it sits; exact reciprocal, one write per own row. On the card
           K7's candidate walk with such candidates dropped when staged
           (csrc/sorted_grid.cuh, IdGrid<T, true>). P7 (:204-212)
           launches k1_kernel once more for its parity line against the
           shipped kernel: the same instance, another caller;
  `v3_k2`  k2_kernel (:145-183): the same forces accumulated over the nine
           (dx, dy) neighbour columns, three dz blocks each, with no
           27-block concat. On the card k1's walk with group sums
           (IdGrid<T, true, 3>): each row's sum over a column's three dz
           entries kept apart and the nine added in group order.

The docstring's K3 (r2 by an MXU dot) has no body in the script: nothing to
port. CPU tensors go to the plain twins, CUDA tensors to
csrc/lj_column_full.cu (the K7 source; ops/cuda_build) or raise. Each
wrapper counts its CUDA launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import cuda_build
from ..ops.column_kernels import column_channels
from ..ops.pair_kernels import check_launch, check_pad_cutoff, stencil

SOURCE = cuda_build.CSRC / "lj_column_full.cu"


def v3_reference(key, ncells, gx, gy, gz, gi, prd, grouped=False):
    """Plain PyTorch k1 (or, `grouped`, k2): the 27-cell walk masked by
    own_id != cand_id, cand_id >= 0 and r2 < cutsq. k2 sums the three dz
    blocks of each (dx, dy) column first and adds the nine column sums in
    order, as its body does. Returns (fx, fy, fz), each [nx*ny, nz, cc]."""
    _, lj1, lj2, cutsq = key
    fl = column_channels(ncells, gx, gy, gz, gi, prd)
    nx, ny, nz = ncells
    own_i = fl[3].reshape(nx, ny, nz, -1)[..., :, None]
    out = [torch.zeros_like(a).reshape(nx, ny, nz, -1) for a in fl[:3]]
    acc = [torch.zeros_like(a) for a in out]
    for n, (d, r2, _, (ic,)) in enumerate(stencil(ncells, *fl[:3], prd,
                                                  (fl[3],))):
        ic = ic[..., None, :]
        valid = (own_i != ic) & (ic >= 0) & (r2 < cutsq)
        r2inv = 1.0 / torch.where(valid, r2, 1.0)
        r6inv = r2inv * r2inv * r2inv
        fpair = torch.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
        for dim in range(3):
            acc[dim] += torch.sum(d[dim] * fpair, dim=-1)
        if not grouped or n % 3 == 2:  # the stencil's dz runs innermost
            for dim in range(3):
                out[dim] += acc[dim]
                acc[dim] = torch.zeros_like(acc[dim])
    return tuple(a.reshape(gx.shape) for a in out)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("lj_column_v3_k1_f32", "lj_column_v3_k1_f64",
                 "lj_column_v3_k2_f32", "lj_column_v3_k2_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [f64] * 3 + [ptr]
        fn.restype = i32
    return lib


def _wrapper(name, grouped, doc):
    def run(key, ncells, gx, gy, gz, gi, prd):
        if key[0] != "lj":
            raise NotImplementedError(f"no column kernel for style "
                                      f"{key[0]!r}")
        fl = column_channels(ncells, gx, gy, gz, gi, prd)
        if gx.device.type == "cpu":
            return v3_reference(key, ncells, gx, gy, gz, gi, prd, grouped)
        check_launch(fl, prd)
        cc = gx.shape[-1]
        _, lj1, lj2, cutsq = key
        check_pad_cutoff(cutsq)  # the walk's pad skip of the sorted layout
        out = torch.empty((3,) + tuple(gx.shape), dtype=gx.dtype,
                          device=gx.device)
        suffix = "f32" if gx.dtype == torch.float32 else "f64"
        fn = getattr(_library(), f"lj_column_{name}_{suffix}")
        with torch.cuda.device(gx.device):
            stream = torch.cuda.current_stream(gx.device).cuda_stream
            err = fn(*(a.data_ptr() for a in fl), prd.data_ptr(),
                     out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                     *ncells, cc, lj1, lj2, cutsq, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        run.launches += 1
        return out[0], out[1], out[2]

    run.__name__ = run.__qualname__ = name
    run.__doc__ = doc
    run.launches = 0
    return run


v3_k1 = _wrapper("v3_k1", False, """P6 K1 (and P7): lj/cut forces over the
    27-cell stencil, a pair taken where own_id != cand_id, cand_id >= 0 and
    r2 < cutsq. key: ("lj", lj1, lj2, cutsq); gx, gy, gz, gi: [nx*ny, nz,
    cc] positions and float ids (-1 for padding); prd: [3]. Returns (fx,
    fy, fz), each [nx*ny, nz, cc].""")
v3_k2 = _wrapper("v3_k2", True, """P6 K2: `v3_k1`'s forces with each
    (dx, dy) column's sum kept apart and the nine column sums added in
    order. Arguments and result as `v3_k1`.""")
