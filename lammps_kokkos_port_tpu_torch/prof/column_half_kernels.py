"""P2, P3, P5, P8 and P11, the Newton-half column passes of the profiling
scripts: CUDA for Hopper, plus their plain twins.

Replaces the Pallas bodies of five scripts in benchmarks/prof/, each lj/cut
over the half stencil (ops/half_kernels.HALF) of the column layout
`[nx*ny, nz, cc]`:

  P5  prof_kernel_iso.py:99 (`make_kernel(mode)` :11-92), one pass a mode:
      `iso_full`: K8's forces, every reaction landed on its candidate's
      row; `iso_batched`: the same forces, the reactions grouped by (dx,
      dy) target and z, then gathered by a fold; `iso_redonly`: forward
      sums plus the own block's reactions; `iso_noreverse`: forward sums
      only; `iso_noassembly`: the candidates are never staged, every
      output is NaN (the last three are timing ablations, not forces);
  P8  prof_kernel_writeonce.py:120 (`_wo_kernel` :31-107): `writeonce`,
      the forward sums and rc `[nx*ny, 3, nz, 5*cc]`, the reactions grouped
      by target (half_kernels.TARGETS), the own block's among them;
      `fold_targets` is the script's periodic roll fold outside the kernel
      (:130-138), `wo_half_force` both: K1's forces;
  P2  prof_halfv2.py:151 (`make_v2` :44-161): `halfv2` and
      `halfv2_approx`, K1's id-free forces (slot order in the self block,
      0 < r2) with the exact or the approximate reciprocal;
  P11 prof_zchunk.py:68 (`fwd_kern` :121-141, `fused_kern` :149-168):
      `zchunk_fwd`, the pass of `iso_noreverse` (and of P10's function),
      and `zchunk_fused`, forward only, id-free, 0 < r2 < cutsq (both
      orders in the self block), approximate reciprocal;
  P3  prof_kernel_cc32.py:182 (`t2_call` :181-189, `t2_kernel` :90-177):
      `cc32_half`, `iso_full`'s forces and reactions with the mask
      own_id < cand_id and own_id >= 0 (:153-156), so a padding row takes no
      pair wherever it sits. The script stages its 14 blocks as 128-lane
      tiles of four blocks and fills the last tile's 64 lanes with -1.0 in
      every channel (:136-142): TPU lane alignment, lanes that never pass
      the mask, which have no counterpart here.

The kernels (csrc/lj_column_half.cu, whose note gives the design) are
instances of the shared candidate walk (csrc/cell_walk.cuh): one warp per
cell, only live candidates near the warp's rows staged, each reaction
landed by a global reduction, on the candidate's row (`iso_full`,
`cc32_half`, `iso_redonly`, `iso_noassembly`: into zeros, in f32 an
interleaved buffer as K8's, half_kernels.output) or in target blocks
(`iso_batched`, `halfv2*`: gathered by a fold launch; `writeonce`: rc).
They are bound by issue slots and latency, not bytes.

Every wrapper takes `(key, ncells, idcap, gx, gy, gz, gi, prd, zb=None)`:
the channels of prof/grid.SortedPlanes.col, float ids `gi` (-1 for
padding) offset by `idcap` in the 13 neighbour blocks; the id-free passes
read neither `gi` nor `idcap` (K1's interface). `zb`, the scripts' z chunk,
is here the number of cells (warps, consecutive z of a column) of one CUDA
block: it sets the occupancy and never the result, and the twins ignore
it. Each pass is compiled for the chunks its entry points ask for (`ZB`;
the default, None, is four cells a block) and any other `zb` raises,
also on the CPU. CPU tensors go to the twins (`reference`), CUDA tensors
to the kernels (built with nvcc at first use, ops/cuda_build) or raise.
Each wrapper counts its CUDA calls in `.launches` (the output's zeroing,
the pass and its fold are one call).
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
import shutil
import subprocess

import torch

from ..ops import cuda_build
from ..ops.column_kernels import column_channels
from ..ops.half_kernels import (TARGETS, check_id_limit, half_walk, output,
                                plane_half_fits)
from ..ops.pair_kernels import check_launch, check_pad_cutoff

SOURCE = cuda_build.CSRC / "lj_column_half.cu"
# cells a block where the caller names no z chunk (cell_walk.cuh)
DEFAULT_ZB = 4

# name: (pass number of csrc/lj_column_half.cu, the plain walk's options)
SPECS = {
    "iso_full": (0, dict(mask="ids", react="cell")),
    "iso_batched": (1, dict(mask="ids", react="target")),
    "iso_redonly": (2, dict(mask="ids", react="own")),
    "iso_noreverse": (3, dict(mask="ids", react="none")),
    "iso_noassembly": (4, dict(mask="ids", react="cell")),
    "writeonce": (9, dict(mask="ids", react="target")),
    "halfv2": (5, dict(mask="slot", react="target")),
    "halfv2_approx": (6, dict(mask="slot", recip="approx", react="target")),
    "zchunk_fwd": (3, dict(mask="ids", react="none")),
    "zchunk_fused": (7, dict(mask="dist", recip="approx", react="none")),
    "cc32_half": (8, dict(mask="ids_live", react="cell")),
}
# the z chunks each pass is compiled for: those its entry points ask for
# (prof.halfv2: 2 and 4; prof.zchunk: nz, 4, 2 and 1, nz being 12 at the
# scripts' 20-cell melt and 3 at the 6-cell one the tests run); the
# others take the default only
_CHUNKS = (1, 2, 3, 4, 12)
ZB = {name: (DEFAULT_ZB,) for name in SPECS}
ZB.update({"halfv2": (2, 4), "halfv2_approx": (2, 4),
           "zchunk_fwd": _CHUNKS, "zchunk_fused": _CHUNKS})


def cells_per_block(name: str, zb=None) -> int:
    """The cells of one CUDA block for pass `name` at z chunk `zb` (None:
    the default); raises for a chunk the pass is not compiled for."""
    if zb is None:
        return DEFAULT_ZB
    if zb not in ZB[name]:
        raise ValueError(f"{name}: zb {zb} is not compiled; its z chunks are"
                         f" {ZB[name]} (or None, {DEFAULT_ZB} cells a "
                         "block)")
    return zb


def bound_planes(name: str) -> int:
    """The [nx*ny*nz, cc] planes pass `name` must move at the least: its
    inputs read once (x, y, z, and the ids where its mask reads them) and
    its outputs written once (three force planes; `writeonce`'s rc, 15
    more). No scratch of the implementation counts."""
    mask = SPECS[name][1]["mask"]
    inputs = 4 if mask.startswith("ids") else 3
    return inputs + 3 + (3 * len(TARGETS) if name == "writeonce" else 0)


def _channels(name, ncells, idcap, gx, gy, gz, gi, prd, zb):
    """Validate the inputs; return the [nx*ny*nz, cc] channels and the
    cells of a block."""
    if not plane_half_fits(ncells):
        raise ValueError(f"column-half grid {tuple(ncells)} needs nx, ny >= "
                         "2 and nz >= 3")
    fl = column_channels(ncells, gx, gy, gz, gi, prd)
    if SPECS[name][1]["mask"].startswith("ids"):
        check_id_limit(gi, idcap)
    return fl, cells_per_block(name, zb)


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


ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_double] * 4 + [ctypes.c_void_p])


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"lj_column_half_{suffix}")
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def launch(name, key, ncells, idcap, fl, prd, zb=None):
    """One call of pass `name` on the [nx*ny*nz, cc] channels `fl`: the
    outputs' zeroing, the pass and its fold. Returns three [nx*ny*nz, cc]
    force views, and rc for `writeonce`. Counts nothing."""
    _, lj1, lj2, cutsq = key
    check_pad_cutoff(cutsq)
    check_launch(fl, prd)
    number, walk = SPECS[name]
    w = cells_per_block(name, zb)
    nx, ny, nz = ncells
    ncell, cc = fl[0].shape
    rows = ncell * cc
    dt, dev = fl[0].dtype, fl[0].device
    rc = None
    if walk["react"] in ("cell", "own"):  # adds into zeros (K8's layout)
        buf, f = output(rows, dt, dev, react=True)
    else:
        buf = torch.empty((3, rows), dtype=dt, device=dev)
        f = buf.unbind(0)
    if name == "writeonce":  # the script's rc
        rc = torch.zeros((nx * ny, 3, nz, len(TARGETS) * cc), dtype=dt,
                         device=dev)
    elif walk["react"] == "target":  # 5 blocks a cell, 4 values a row
        rc = torch.zeros((4 if dt == torch.float32 else 3) * len(TARGETS)
                         * rows, dtype=dt, device=dev)
    fn = getattr(_library(), "lj_column_half_"
                 + ("f32" if dt == torch.float32 else "f64"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(number, w, *(a.data_ptr() for a in fl), prd.data_ptr(),
                 buf.data_ptr(), 0 if rc is None else rc.data_ptr(), nx, ny,
                 nz, cc, float(idcap), lj1, lj2, cutsq, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return (*f, rc) if name == "writeonce" else tuple(f)


def _wrapper(name, doc):
    def run(key, ncells, idcap, gx, gy, gz, gi, prd, zb=None):
        if key[0] != "lj":
            raise NotImplementedError(f"no column kernel for style "
                                      f"{key[0]!r}")
        fl, _ = _channels(name, ncells, idcap, gx, gy, gz, gi, prd, zb)
        if gx.device.type == "cpu":
            return _plain(name, key, ncells, idcap, fl, prd, gx.shape)
        out = launch(name, key, ncells, idcap, fl, prd, zb)
        run.launches += 1
        f = tuple(a.reshape(gx.shape) for a in out[:3])
        return (*f, out[3]) if name == "writeonce" else f

    run.__name__ = run.__qualname__ = name
    run.__doc__ = doc
    run.launches = 0
    return run


iso_full = _wrapper("iso_full", """P5 `full`: lj/cut forces, Newton-half,
    each reaction landed on its candidate's row (K8's function and
    scheme). Returns (fx, fy, fz), each [nx*ny, nz, cc] (on the card in
    f32: views of one interleaved buffer).""")
iso_batched = _wrapper("iso_batched", """P5 `batched`: `iso_full`'s forces,
    the reactions landed by (dx, dy) target and z in the column's target
    blocks and gathered over the 5 source columns by a fold launch.
    Returns (fx, fy, fz).""")
iso_redonly = _wrapper("iso_redonly", """P5 `redonly`: the forward sums and
    the own block's reactions; the 13 other blocks' are not landed (wrong
    forces, a timing ablation). Returns (fx, fy, fz).""")
iso_noreverse = _wrapper("iso_noreverse", """P5 `noreverse`: the forward
    half sums only, P10's function (a timing ablation). Returns (fx, fy,
    fz).""")
iso_noassembly = _wrapper("iso_noassembly", """P5 `noassembly`:
    `iso_full` with the candidate blocks never read from memory; every slot
    is walked as a NaN candidate, so every output is NaN (a timing
    ablation). Returns (fx, fy, fz).""")
writeonce = _wrapper("writeonce", """P8: the forward half sums (without
    the own block's reactions) and rc [nx*ny, 3, nz, 5*cc], rc[col, c, z,
    t*cc + j] the reactions owed to row j of cell (col + TARGETS[t], z).
    Returns (fx, fy, fz, rc); `fold_targets` folds them into forces.""")
halfv2 = _wrapper("halfv2", """P2: K1's forces, id-free (the self block's
    slot order and 0 < r2 < cutsq, r2 clamped at 0.25), exact reciprocal;
    reactions in target blocks and a fold, as `iso_batched`'s. Returns
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


# the kernel instances of a build log: (type, mask, reciprocal, landing)
# of csrc/lj_column_half.cu and the passes each serves
_MASKS = ("ids", "ids_live", "slot", "dist", "unstaged")
_LANDS = ("none", "row", "own_row", "target", "script_target")
_INSTANCE = re.compile(r"column_half_kernel<(float|double), .*?Mask\)(\d+), "
                       r"(?:\(bool\))?(\w+), .*?Land\)(\d+), "
                       r"(?:\(int\))?(\d+)>")


def instance_registers(log: str) -> list:
    """ptxas's registers of each kernel in a build log of
    lj_column_half.cu, [(name, registers)] in the compiler's order, each
    kernel named by its template arguments (demangled with cu++filt where
    the toolkit has it; the mangled name otherwise)."""
    pairs, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            pairs.append((name, int(m.group(1))))
            name = None
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        names = subprocess.run([tool], input="\n".join(n for n, _ in pairs),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [n for n, _ in pairs]
    if len(names) != len(pairs):
        names = [n for n, _ in pairs]
    out = []
    for plain, (mangled, regs) in zip(names, pairs):
        m = _INSTANCE.search(plain)
        if m:
            t, mask, approx, land, w = m.groups()
            recip = " approx" if approx in ("true", "1") else ""
            plain = (f"{'f32' if t == 'float' else 'f64'} "
                     f"{_MASKS[int(mask)]}{recip} {_LANDS[int(land)]} "
                     f"zb={w}")
        elif "target_fold" in plain:
            plain = f"target_fold {'f32' if 'float' in plain else 'f64'}"
        out.append((plain, regs))
    return out
