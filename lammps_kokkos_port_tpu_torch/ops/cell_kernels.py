"""The lj/cut force kernel of list mode "cell": CUDA for Hopper, plus its
plain twin.

Replaces the JAX package's `cell_force_pallas`
(lammps_kokkos_port_tpu/ops/pallas_pair.py:100-131, kernel `_pair_kernel`
:66-96) together with its glue `compute_force` (:851-930): the gather of
own and candidate rows, the kernel, and the `.at[].set(mode="drop")`
scatter back to atom order. One kernel serves every grid size; the JAX
package's 300k-row split between K1 and K6 (`_VMEM_ROW_LIMIT`, :876) is TPU
VMEM tiling and has no counterpart here.

`lj_cell_dense` is the entry point. CPU tensors go to the plain PyTorch
version `lj_cell_dense_reference` (the CPU tests use it); CUDA tensors go
to the kernel in `csrc/lj_cell_dense.cu`, built with nvcc at first use into
`_build/` and bound with ctypes (ops/cuda_build). There is no fallback
from a CUDA tensor to the plain version: the wrapper launches the kernel
or raises.

Masks are by atom index, never by position: a bucket entry equal to the
state capacity is an empty lane, a candidate with the own atom's index is
the self pair, and a stencil entry equal to the cell count (the dead cell
across a non-periodic face) contributes nothing. The minimum image is
`d - prd * rint(d * (1/prd))` per axis, as K6 computes it; the kernel
rounds each product and sum explicitly, so both versions make the same
cutoff decisions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .pair_kernels import bind_walk_library, walk_launch

SOURCE = cuda_build.CSRC / "lj_cell_dense.cu"


def _check(buckets, stencil, x, prd):
    """Validate the inputs: buckets [ntot+1, cc] int32, stencil [ntot, 27]
    int32, x [cap, 3] and prd [3] of one float dtype, all on one device."""
    if buckets.dtype != torch.int32 or buckets.ndim != 2:
        raise ValueError("buckets must be an [ncells+1, cell_cap] int32 "
                         "tensor")
    ntot = buckets.shape[0] - 1
    if stencil.dtype != torch.int32 or tuple(stencil.shape) != (ntot, 27):
        raise ValueError(f"stencil must be a [{ntot}, 27] int32 tensor, got "
                         f"{tuple(stencil.shape)} {stencil.dtype}")
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be [cap, 3], got {tuple(x.shape)}")
    if prd.shape != (3,) or prd.dtype != x.dtype:
        raise ValueError("prd must be a [3] tensor of x's dtype")
    if not all(a.device == x.device for a in (buckets, stencil, prd)):
        raise ValueError("buckets, stencil, x and prd must share a device")


def lj_cell_dense_reference(key, buckets, stencil, x, prd,
                            cell_chunk: int = 128):
    """Plain PyTorch lj/cut force-only pass over the dense buckets, in
    chunks of `cell_chunk` cells (the JAX cell path's chunk), so memory
    stays bounded on large grids. Returns f [cap, 3] in atom order."""
    _, lj1, lj2, cutsq = key
    cap = x.shape[0]
    ntot, cc = buckets.shape[0] - 1, buckets.shape[1]
    inv = 1.0 / prd
    valid_b = buckets < cap
    xb = x[torch.clamp(buckets, max=cap - 1).long()]  # [ntot+1, cc, 3]
    f = torch.zeros_like(x)
    for c0 in range(0, ntot, cell_chunk):
        cids = slice(c0, min(c0 + cell_chunk, ntot))
        own_idx = buckets[cids]
        own_valid = valid_b[cids]
        nch = own_idx.shape[0]
        n27 = stencil[cids].long()
        live = (n27 < ntot)[:, :, None].expand(nch, 27, cc).reshape(nch, -1)
        cand_idx = buckets[n27].reshape(nch, 27 * cc)
        cand_valid = valid_b[n27].reshape(nch, 27 * cc) & live
        d = xb[cids][:, :, None, :] - xb[n27].reshape(nch, 1, 27 * cc, 3)
        d = d - prd * torch.round(d * inv)
        dx, dy, dz = d.unbind(-1)
        r2 = dx * dx + dy * dy + dz * dz  # [chunk, cc, 27cc]
        valid = (own_valid[:, :, None] & cand_valid[:, None, :]
                 & (own_idx[:, :, None] != cand_idx[:, None, :])
                 & (r2 < cutsq))
        r2inv = 1.0 / torch.where(valid, r2, 1.0)
        r6inv = r2inv * r2inv * r2inv
        fpair = torch.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
        fch = torch.sum(d * fpair[..., None], dim=2)  # [chunk, cc, 3]
        f[own_idx[own_valid].long()] = fch[own_valid]
    return f


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    return bind_walk_library(cuda_build.load(SOURCE), "lj_cell_dense", 5, 3,
                             3)


def launch_shape(ncell: int, dtype) -> dict:
    """The launch `lj_cell_dense` makes on `ncell` cells in `dtype` (builds
    the library)."""
    return walk_launch(_library(), "lj_cell_dense", ncell, dtype)


def lj_cell_dense(key, buckets, stencil, x, prd):
    """lj/cut forces of every bucketed atom.

    key: ("lj", lj1, lj2, cutsq) from PairLJCut.kernel_key(); buckets:
    [ncells+1, cc] int32 atom rows (== cap for an empty lane); stencil:
    [ncells, 27] int32 neighbour cell ids (== ncells for none); x: [cap, 3]
    positions; prd: [3] box lengths. Returns f [cap, 3]: each bucketed
    atom's force, zero for the others. Every launch of the CUDA kernel adds
    one to `lj_cell_dense.launches`.
    """
    if key[0] != "lj":
        raise NotImplementedError(f"no cell kernel for style {key[0]!r}")
    _check(buckets, stencil, x, prd)
    if x.device.type == "cpu":
        return lj_cell_dense_reference(key, buckets, stencil, x, prd)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {x.dtype}")
    if not all(a.is_contiguous() for a in (buckets, stencil, x, prd)):
        raise ValueError("kernel inputs must be contiguous")
    ntot, cc = buckets.shape[0] - 1, buckets.shape[1]
    _, lj1, lj2, cutsq = key
    f = torch.zeros_like(x)
    fn = (_library().lj_cell_dense_f32 if x.dtype == torch.float32
          else _library().lj_cell_dense_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(buckets.data_ptr(), stencil.data_ptr(), x.data_ptr(),
                 prd.data_ptr(), f.data_ptr(), ntot, cc, x.shape[0], lj1,
                 lj2, cutsq, stream)
    if err != 0:
        raise RuntimeError(f"lj_cell_dense launch failed: CUDA error {err}")
    lj_cell_dense.launches += 1
    return f


lj_cell_dense.launches = 0
