"""The lj/cut cell force kernel: CUDA for Hopper, plus its plain twin.

Replaces the three Pallas TPU kernels of the JAX package's sorted path,
which compute the same forces and differ only in how they tile TPU memory:
`column_half_force_pallas` (lammps_kokkos_port_tpu/ops/pallas_pair.py:319),
`slab_half_force_pallas` (:659) and `plane_force_pallas` (:811). One kernel
serves every grid size, so the port has no column/slab dispatch.

`lj_cell_force` is the entry point. CPU tensors go to the plain PyTorch
version `lj_cell_force_reference` (the CPU tests use it); CUDA tensors go
to the kernel in `csrc/lj_cell_force.cu`, which is built with nvcc at first
use into `_build/` and bound with ctypes. There is no fallback from a CUDA
tensor to the plain version: the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "lj_cell_force.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_CELL_CAP = 1024  # one thread per row, one block row per cell

_OFFSETS = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
            for oz in (-1, 0, 1)]


def _check(key, ncells, gx, gy, gz, prd):
    if key[0] != "lj":
        raise NotImplementedError(f"no cell kernel for style {key[0]!r}")
    nx, ny, nz = ncells
    if min(nx, ny, nz) < 3:
        # with fewer than 3 cells a dim's -1 and +1 neighbours coincide and
        # the 27-cell stencil would count a pair twice
        raise ValueError(f"cell grid {tuple(ncells)} needs >= 3 cells per "
                         "dim")
    shape = gx.shape
    if len(shape) != 2 or shape[0] != nx * ny * nz:
        raise ValueError(f"grid tensors must be [ncells={nx * ny * nz}, cc]"
                         f", got {tuple(shape)}")
    for a in (gy, gz):
        if a.shape != shape or a.dtype != gx.dtype or a.device != gx.device:
            raise ValueError("gx, gy, gz must share shape, dtype and device")
    if prd.shape != (3,) or prd.dtype != gx.dtype or prd.device != gx.device:
        raise ValueError("prd must be a [3] tensor of the grid's dtype and "
                         "device")


def lj_cell_force_reference(key, ncells, gx, gy, gz, prd):
    """Plain PyTorch lj/cut force-only pass over the cell-major grid.

    For each of the 27 neighbour offsets the grid is rolled so that cell c
    faces cell c+offset; cells whose neighbour wraps across the box get an
    explicit +-prd shift on the candidate coordinates (no minimum image).
    The self pair is excluded by lane index in the own cell. Returns
    [3, ncells, cc] (fx, fy, fz stacked on the leading axis).
    """
    _, lj1, lj2, cutsq = key
    nx, ny, nz = ncells
    cc = gx.shape[-1]
    dev = gx.device
    own = [a.reshape(nx, ny, nz, cc) for a in (gx, gy, gz)]
    lane = torch.arange(cc, device=dev)
    not_self = lane[:, None] != lane[None, :]
    out = [torch.zeros_like(a) for a in own]
    for off in _OFFSETS:
        d = []
        for dim, n in enumerate(ncells):
            cand = torch.roll(own[dim], shifts=(-off[0], -off[1], -off[2]),
                              dims=(0, 1, 2))
            w = torch.arange(n, device=dev) + off[dim]
            shift = torch.where(w < 0, -prd[dim],
                                torch.where(w >= n, prd[dim], 0.0))
            view = [1, 1, 1, 1]
            view[dim] = n
            cand = cand + shift.reshape(view)
            d.append(own[dim][..., :, None] - cand[..., None, :])
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]  # [nx,ny,nz,cc,cc]
        valid = r2 < cutsq
        if off == (0, 0, 0):
            valid = valid & not_self
        r2inv = 1.0 / torch.where(valid, r2, 1.0)
        r6inv = r2inv * r2inv * r2inv
        fpair = torch.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
        for dim in range(3):
            out[dim] += torch.sum(d[dim] * fpair, dim=-1)
    return torch.stack(out).reshape(3, nx * ny * nz, cc)


def _lib_path() -> Path:
    """Library path keyed by a hash of the source and the flags."""
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"liblj_cell_force-{tag}.so"


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib_path = _lib_path()
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernel cannot be "
                               "built on this machine")
        BUILD_DIR.mkdir(exist_ok=True)
        # build under a temporary name, then rename: concurrent processes
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
            lib_path.with_suffix(".log").write_text(res.stdout + res.stderr)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("lj_cell_force_f32", "lj_cell_force_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 7 + [i32] * 4 + [f64] * 3 + [ptr]
        fn.restype = i32
    return lib


def build() -> str:
    """Build and load the kernel library now; returns the compiler's log
    (register and shared-memory use per kernel, from `-Xptxas -v`)."""
    _library()
    log = _lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def lj_cell_force(key, ncells, gx, gy, gz, prd):
    """lj/cut forces on every row of the cell-major grid.

    key: ("lj", lj1, lj2, cutsq) from PairLJCut.kernel_key(); ncells: the
    (nx, ny, nz) grid, each >= 3; gx, gy, gz: [nx*ny*nz, cc] positions with
    cell id (cx*ny+cy)*nz+cz; prd: [3] box lengths. Returns [3, ncells, cc]
    (fx, fy, fz on the leading axis). Every launch of the CUDA kernel adds
    one to `lj_cell_force.launches`.
    """
    _check(key, ncells, gx, gy, gz, prd)
    if gx.device.type == "cpu":
        return lj_cell_force_reference(key, ncells, gx, gy, gz, prd)
    if gx.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {gx.device}")
    if gx.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {gx.dtype}")
    if not all(a.is_contiguous() for a in (gx, gy, gz, prd)):
        raise ValueError("kernel inputs must be contiguous")
    ncell, cc = gx.shape
    if cc > MAX_CELL_CAP:
        raise ValueError(f"cell_cap {cc} > {MAX_CELL_CAP}")
    _, lj1, lj2, cutsq = key
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
