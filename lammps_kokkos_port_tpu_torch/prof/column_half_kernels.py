"""P2, P3, P5, P8 and P11, the Newton-half column passes of the profiling
scripts: CUDA for Hopper, plus their plain twins.

Replaces the Pallas bodies of five scripts in benchmarks/prof/, each lj/cut
over the half stencil (ops/half_kernels.HALF) of the column layout
`[nx*ny, nz, cc]`:

  P5  prof_kernel_iso.py:99 (`make_kernel(mode)` :11-92), one pass a mode:
      `iso_full`: K8's forces, every reaction written to its neighbour
      cell; `iso_batched`: the same forces, the reactions grouped by (dx,
      dy) target before they leave the block; `iso_redonly`: forward sums
      plus the own block's reactions; `iso_noreverse`: forward sums only;
      `iso_noassembly`: the candidates are never staged, every output is
      NaN (the last three are timing ablations, not forces);
  P8  prof_kernel_writeonce.py:120 (`_wo_kernel` :31-107): `writeonce`,
      the forward sums and rc `[nx*ny, 3, nz, 5*cc]`, the reactions written
      once per column, grouped by target (half_kernels.TARGETS), the own
      block's among them; `fold_targets` is the script's periodic roll
      fold outside the kernel (:130-138), `wo_half_force` both: K1's forces;
  P2  prof_halfv2.py:151 (`make_v2` :44-161): `halfv2` and
      `halfv2_approx`, K1's id-free forces (slot order in the self block,
      0 < r2) with the exact or the approximate reciprocal;
  P11 prof_zchunk.py:68 (`fwd_kern` :121-141, `fused_kern` :149-168):
      `zchunk_fwd`, the pass of `iso_noreverse` (and of P10's function),
      and `zchunk_fused`, forward only, id-free, 0 < r2 < cutsq (both
      orders in the self block), approximate reciprocal;
  P3  prof_kernel_cc32.py:182 (`t2_call` :181-189, `t2_kernel` :90-177):
      `cc32_half`, `iso_full`'s forces and reaction scheme with the mask
      own_id < cand_id and own_id >= 0 (:153-156), so a padding row takes no
      pair wherever it sits. The script stages its 14 blocks as 128-lane
      tiles of four blocks and fills the last tile's 64 lanes with -1.0 in
      every channel (:136-142): TPU lane alignment, lanes that never pass
      the mask, which have no counterpart here.

Every wrapper takes `(key, ncells, idcap, gx, gy, gz, gi, prd, zb=None)`:
the channels of prof/grid.SortedPlanes.col, float ids `gi` (-1 for
padding) offset by `idcap` in the 13 neighbour blocks; the id-free passes
read neither `gi` nor `idcap` (K1's interface). `zb` is the number of z
cells of one column that a CUDA block walks at a time, one warp row each
(default: the whole column, up to 1024 threads): it sets the occupancy
and never the result, and the twins ignore it. CPU tensors go to the
twins (`reference`), CUDA tensors to csrc/lj_column_half.cu (built with
nvcc at first use, ops/cuda_build) or raise. Each wrapper counts its CUDA
calls in `.launches` (a pass and its reaction fold are one call).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..ops import cuda_build
from ..ops.column_kernels import column_channels
from ..ops.half_kernels import (HALF, TARGETS, check_id_limit, half_walk,
                                plane_half_fits)
from ..ops.pair_kernels import check_launch

SOURCE = cuda_build.CSRC / "lj_column_half.cu"
MAX_THREADS = 1024  # a block's threads: cc rounded up to a warp, times zb

# name: (pass number of csrc/lj_column_half.cu, the plain walk's options)
SPECS = {
    "iso_full": (0, dict(mask="ids", react="cell")),
    "iso_batched": (1, dict(mask="ids", react="target")),
    "iso_redonly": (2, dict(mask="ids", react="own")),
    "iso_noreverse": (3, dict(mask="ids", react="none")),
    "iso_noassembly": (4, dict(mask="ids", react="cell")),
    "writeonce": (1, dict(mask="ids", react="target")),
    "halfv2": (5, dict(mask="slot", react="target")),
    "halfv2_approx": (6, dict(mask="slot", recip="approx", react="target")),
    "zchunk_fwd": (3, dict(mask="ids", react="none")),
    "zchunk_fused": (7, dict(mask="dist", recip="approx", react="none")),
    "cc32_half": (8, dict(mask="ids_live", react="cell")),
}


def _channels(name, ncells, idcap, gx, gy, gz, gi, prd, zb):
    """Validate the inputs; return the [nx*ny*nz, cc] channels and the warp
    rows of a block."""
    if not plane_half_fits(ncells):
        raise ValueError(f"column-half grid {tuple(ncells)} needs nx, ny >= "
                         "2 and nz >= 3")
    fl = column_channels(ncells, gx, gy, gz, gi, prd)
    if SPECS[name][1]["mask"].startswith("ids"):
        check_id_limit(gi, idcap)
    nz, cc = ncells[2], gx.shape[-1]
    lanes = -(-cc // 32) * 32
    if zb is None:
        rows = min(nz, MAX_THREADS // lanes)
    elif zb >= 1:
        rows = min(zb, nz)
    else:
        raise ValueError(f"zb must be >= 1, got {zb}")
    if lanes * rows > MAX_THREADS:
        raise ValueError(f"zb {rows} x {lanes} lanes > {MAX_THREADS} threads")
    return fl, rows


def fold_targets(ncells, f, rc):
    """prof_kernel_writeonce.py:130-138: the forces `f` (three [nx*ny, nz,
    cc]) plus rc's target blocks, each rolled onto its (dx, dy) target
    column (periodic; the z alignment is already in rc)."""
    nx, ny, nz = ncells
    cc = f[0].shape[-1]
    rc5 = rc.reshape(nx, ny, 3, nz, len(TARGETS), cc)
    out = list(f)
    for t, (dx, dy) in enumerate(TARGETS):
        blk = torch.roll(rc5[:, :, :, :, t, :], (dx, dy), dims=(0, 1))
        for ci in range(3):
            out[ci] = out[ci] + blk[:, :, ci].reshape(nx * ny, nz, cc)
    return tuple(out)


def _plain(name, key, ncells, idcap, fl, prd, shape):
    if name == "iso_noassembly":
        # every candidate reads NaN, so every sum is NaN
        return tuple(torch.full(shape, math.nan, dtype=fl[0].dtype,
                                device=fl[0].device) for _ in range(3))
    walk = SPECS[name][1]
    res = half_walk(key, ncells, fl, prd, idcap, **walk)
    if walk["react"] != "target":
        return tuple(a.reshape(shape) for a in res)
    f, rc = res
    f = tuple(a.reshape(shape) for a in f)
    return (*f, rc) if name == "writeonce" else fold_targets(ncells, f, rc)


def reference(name, key, ncells, idcap, gx, gy, gz, gi, prd, zb=None):
    """The plain twin of pass `name` (a key of PASSES): three [nx*ny, nz,
    cc] tensors, with rc after them for `writeonce`."""
    fl, _ = _channels(name, ncells, idcap, gx, gy, gz, gi, prd, zb)
    return _plain(name, key, ncells, idcap, fl, prd, gx.shape)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("lj_column_half_f32", "lj_column_half_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [i32] * 3 + [ptr] * 9 + [i32] * 4 + [f64] * 4 + [ptr]
        fn.restype = i32
    return lib


def _launch(name, key, ncells, idcap, fl, prd, rows, shape):
    check_launch(fl, prd)
    number, walk = SPECS[name]
    nx, ny, nz = ncells
    ncell, cc = fl[0].shape
    _, lj1, lj2, cutsq = key
    dt, dev = fl[0].dtype, fl[0].device
    out = torch.empty((3, ncell, cc), dtype=dt, device=dev)
    if walk["react"] == "cell":  # 13 blocks of [3, cc] per cell
        rbuf = torch.empty((ncell, len(HALF) - 1, 3, cc), dtype=dt,
                           device=dev)
    elif walk["react"] == "target":  # rc
        rbuf = torch.empty((nx * ny, 3, nz, len(TARGETS) * cc), dtype=dt,
                           device=dev)
    else:
        rbuf = out  # not read
    fn = getattr(_library(), "lj_column_half_"
                 + ("f32" if dt == torch.float32 else "f64"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(number, rows, int(name != "writeonce"),
                 *(a.data_ptr() for a in fl), prd.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                 rbuf.data_ptr(), nx, ny, nz, cc, float(idcap), lj1, lj2,
                 cutsq, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    f = tuple(a.reshape(shape) for a in out)
    return (*f, rbuf) if name == "writeonce" else f


def _wrapper(name, doc):
    def run(key, ncells, idcap, gx, gy, gz, gi, prd, zb=None):
        if key[0] != "lj":
            raise NotImplementedError(f"no column kernel for style "
                                      f"{key[0]!r}")
        fl, rows = _channels(name, ncells, idcap, gx, gy, gz, gi, prd, zb)
        if gx.device.type == "cpu":
            return _plain(name, key, ncells, idcap, fl, prd, gx.shape)
        out = _launch(name, key, ncells, idcap, fl, prd, rows, gx.shape)
        run.launches += 1
        return out

    run.__name__ = run.__qualname__ = name
    run.__doc__ = doc
    run.launches = 0
    return run


iso_full = _wrapper("iso_full", """P5 `full`: lj/cut forces, Newton-half,
    each block's reactions written once per cell and gathered by a fold
    kernel (K8's scheme). Returns (fx, fy, fz), each [nx*ny, nz, cc].""")
iso_batched = _wrapper("iso_batched", """P5 `batched`: `iso_full`'s forces,
    the reactions summed in the block by (dx, dy) target and z, written
    once per column as rc and gathered over the 5 source columns by a fold
    kernel. Returns (fx, fy, fz).""")
iso_redonly = _wrapper("iso_redonly", """P5 `redonly`: the forward sums and
    the own block's reactions; the shared reaction sums of the 13 other
    blocks run and are dropped (wrong forces, a timing ablation). Returns
    (fx, fy, fz).""")
iso_noreverse = _wrapper("iso_noreverse", """P5 `noreverse`: the forward
    half sums only, P10's function (a timing ablation). Returns (fx, fy,
    fz).""")
iso_noassembly = _wrapper("iso_noassembly", """P5 `noassembly`:
    `iso_full` with the candidate blocks never read from memory; the stage
    is filled with NaN and walked, so every output is NaN (a timing
    ablation). Returns (fx, fy, fz).""")
writeonce = _wrapper("writeonce", """P8: the forward half sums (without
    the own block's reactions) and rc [nx*ny, 3, nz, 5*cc], rc[col, c, z,
    t*cc + j] the reactions owed to row j of cell (col + TARGETS[t], z).
    Returns (fx, fy, fz, rc); `fold_targets` folds them into forces.""")
halfv2 = _wrapper("halfv2", """P2: K1's forces, id-free (the self block's
    slot order and 0 < r2 < cutsq, r2 clamped at 0.25), exact reciprocal;
    reactions grouped by target in the block as `iso_batched`'s. Returns
    (fx, fy, fz).""")
halfv2_approx = _wrapper("halfv2_approx", """P2 with the approximate
    reciprocal: rcp.approx.ftz.f32 (f64: seeded from it) and one Newton
    step. Returns (fx, fy, fz).""")
zchunk_fwd = _wrapper("zchunk_fwd", """P11 `fwd`: the forward half sums
    with ids, the pass of `iso_noreverse`. Returns (fx, fy, fz).""")
zchunk_fused = _wrapper("zchunk_fused", """P11 `fused`: forward sums only,
    id-free with no slot order (0 < r2 < cutsq, so the self block takes
    each pair in both orders), approximate reciprocal. Returns (fx, fy,
    fz).""")
cc32_half = _wrapper("cc32_half", """P3 (prof_kernel_cc32.py T2): `iso_full`
    with the mask own_id < cand_id and own_id >= 0, so a padding row (id -1)
    takes no pair, even within the cutoff of a real row. Returns (fx, fy,
    fz).""")

PASSES = {name: globals()[name] for name in SPECS}


def wo_half_force(key, ncells, idcap, gx, gy, gz, gi, prd):
    """prof_kernel_writeonce.py's `wo_half_force`: `writeonce`, then
    `fold_targets`. Returns K1's forces (fx, fy, fz)."""
    *f, rc = writeonce(key, ncells, idcap, gx, gy, gz, gi, prd)
    return fold_targets(ncells, f, rc)
