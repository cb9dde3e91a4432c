"""The two dense-EAM cell sweeps: CUDA for Hopper, plus their plain twins.

Port of `lammps_kokkos_port_tpu/ops/pallas_eam.py`. Its two Pallas TPU
kernels become two CUDA kernels in `csrc/eam_cell.cu`:

  `rho_pallas` (pallas_eam.py:200)   -> `eam_cell_rho`:
      rho_i = sum_j g(u_ij), u = r^2;
  `force_pallas` (pallas_eam.py:219) -> `eam_cell_force`:
      f_i = sum_j dx_ij * fpair, fpair = -((fp_i + fp_j) a(u) + b(u)),

with g, a, b the Chebyshev fits of ops/eamdense, evaluated by Clenshaw on
u clamped to the fits' range. Both take the full 27-cell stencil (the
Pallas kernels are Newton-halved; see the kernel source for why).
`compute_force_sorted` chains them: rho sweep, fp = F'(rho) in plain
PyTorch between the sweeps (the JAX package left it to XLA), force sweep.
One kernel pair serves every grid size (no 300k-row dispatch).

CPU tensors go to the plain PyTorch twins `eam_cell_rho_reference` and
`eam_cell_force_reference`; CUDA tensors go to the kernels, built with
nvcc at first use (ops/cuda_build), or raise. Every kernel launch adds one
to the wrapper's `launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .eamdense import clenshaw, embedding_fp
from .pair_kernels import check_grid, check_launch, stencil

SOURCE = cuda_build.CSRC / "eam_cell.cu"
NG = 29   # g coefficients the kernel takes (ops/eamdense.DEG + 1)
NAB = 28  # a and b coefficients (derivative series)


def rho_tab(tabs: dict, cutsq: float) -> tuple:
    """(g coefficients, u_lo, u_hi, cutsq): the rho sweep's constants, as
    `compute_force_sorted` of the JAX package builds them."""
    u_lo, u_hi = tabs["u_range"]
    return (tuple(float(c) for c in tabs["g"]), float(u_lo), float(u_hi),
            cutsq)


def force_tab(tabs: dict, cutsq: float) -> tuple:
    """(a coefficients, b coefficients, u_lo, u_hi, cutsq)."""
    u_lo, u_hi = tabs["u_range"]
    return (tuple(float(c) for c in tabs["a"]),
            tuple(float(c) for c in tabs["b"]), float(u_lo), float(u_hi),
            cutsq)


def eam_cell_rho_reference(tab, ncells, gx, gy, gz, prd):
    """Plain PyTorch density sweep over the cell-major grid. Returns rho
    [ncells, cc]; padding rows (far sentinels) get 0."""
    g_c, u_lo, u_hi, cutsq = tab
    rho = torch.zeros_like(gx)
    for _, r2, pair_ok, _ in stencil(ncells, gx, gy, gz, prd):
        valid = r2 < cutsq
        if pair_ok is not None:
            valid = valid & pair_ok
        us = torch.clamp(r2, u_lo, u_hi)
        g = torch.where(valid, clenshaw(g_c, us, u_lo, u_hi), 0.0)
        rho += g.sum(-1).reshape(rho.shape)
    return rho


def eam_cell_force_reference(tab, ncells, gx, gy, gz, gfp, prd):
    """Plain PyTorch force sweep with the fp channel `gfp` [ncells, cc].
    Returns [3, ncells, cc] (fx, fy, fz on the leading axis)."""
    a_c, b_c, u_lo, u_hi, cutsq = tab
    fp_i = gfp.reshape(*ncells, gfp.shape[-1])[..., :, None]
    out = [torch.zeros_like(a) for a in (gx, gy, gz)]
    for d, r2, pair_ok, (fp_j,) in stencil(ncells, gx, gy, gz, prd, (gfp,)):
        valid = r2 < cutsq
        if pair_ok is not None:
            valid = valid & pair_ok
        us = torch.clamp(r2, u_lo, u_hi)
        a = clenshaw(a_c, us, u_lo, u_hi)
        b = clenshaw(b_c, us, u_lo, u_hi)
        fpair = torch.where(valid, -((fp_i + fp_j[..., None, :]) * a + b),
                            0.0)
        for dim in range(3):
            out[dim] += torch.sum(d[dim] * fpair, dim=-1).reshape(
                out[dim].shape)
    return torch.stack(out)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    dbl = ctypes.POINTER(ctypes.c_double)
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"eam_cell_rho_{dt}")
        fn.argtypes = [ptr] * 5 + [i32] * 4 + [dbl] + [f64] * 3 + [ptr]
        fn.restype = i32
        fn = getattr(lib, f"eam_cell_force_{dt}")
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [dbl] * 2 + [f64] * 3 + [ptr]
        fn.restype = i32
    return lib


def _coeffs(c, n: int, name: str):
    if len(c) != n:
        raise ValueError(f"the kernel takes {n} {name} coefficients, got "
                         f"{len(c)}")
    return (ctypes.c_double * n)(*c)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def eam_cell_rho(tab, ncells, gx, gy, gz, prd):
    """EAM density of every row of the cell-major grid.

    tab: `rho_tab(...)`; ncells: the (nx, ny, nz) grid, each >= 3; gx, gy,
    gz: [nx*ny*nz, cc] positions with cell id (cx*ny+cy)*nz+cz; prd: [3]
    box lengths. Returns rho [ncells, cc]. Every launch of the CUDA kernel
    adds one to `eam_cell_rho.launches`.
    """
    check_grid(ncells, (gx, gy, gz), prd)
    if gx.device.type == "cpu":
        return eam_cell_rho_reference(tab, ncells, gx, gy, gz, prd)
    check_launch((gx, gy, gz), prd)
    g_c, u_lo, u_hi, cutsq = tab
    g_arr = _coeffs(g_c, NG, "g")
    rho = torch.empty_like(gx)
    fn = (_library().eam_cell_rho_f32 if gx.dtype == torch.float32
          else _library().eam_cell_rho_f64)
    with torch.cuda.device(gx.device):
        err = fn(gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), prd.data_ptr(),
                 rho.data_ptr(), *ncells, gx.shape[1], g_arr, u_lo, u_hi,
                 cutsq, _stream(gx))
    if err != 0:
        raise RuntimeError(f"eam_cell_rho launch failed: CUDA error {err}")
    eam_cell_rho.launches += 1
    return rho


def eam_cell_force(tab, ncells, gx, gy, gz, gfp, prd):
    """EAM forces on every row of the cell-major grid.

    tab: `force_tab(...)`; gfp: [nx*ny*nz, cc] fp = F'(rho) per row (0 on
    padding rows); the rest as `eam_cell_rho`. Returns [3, ncells, cc]
    (fx, fy, fz on the leading axis). Every launch of the CUDA kernel adds
    one to `eam_cell_force.launches`.
    """
    check_grid(ncells, (gx, gy, gz, gfp), prd)
    if gx.device.type == "cpu":
        return eam_cell_force_reference(tab, ncells, gx, gy, gz, gfp, prd)
    check_launch((gx, gy, gz, gfp), prd)
    a_c, b_c, u_lo, u_hi, cutsq = tab
    a_arr, b_arr = _coeffs(a_c, NAB, "a"), _coeffs(b_c, NAB, "b")
    ncell, cc = gx.shape
    out = torch.empty((3, ncell, cc), dtype=gx.dtype, device=gx.device)
    fn = (_library().eam_cell_force_f32 if gx.dtype == torch.float32
          else _library().eam_cell_force_f64)
    with torch.cuda.device(gx.device):
        err = fn(gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), gfp.data_ptr(),
                 prd.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                 out[2].data_ptr(), *ncells, cc, a_arr, b_arr, u_lo, u_hi,
                 cutsq, _stream(gx))
    if err != 0:
        raise RuntimeError(f"eam_cell_force launch failed: CUDA error {err}")
    eam_cell_force.launches += 1
    return out


eam_cell_rho.launches = 0
eam_cell_force.launches = 0


def compute_force_sorted(style, tabs, state, cl):
    """Force-only dense EAM on a SortedCells state through the two sweeps.
    Returns f [cap, 3] in the sorted layout."""
    from .sortedforce import planar

    p = cl.params
    ntot, cc = p.total_cells, p.cell_cap
    cap = state.capacity
    dt = state.dtype
    g = planar(state.x).reshape(3, ntot, cc)
    prd = state.box.prd.to(dt)
    cutsq = float(style.cutmax) ** 2

    rho = eam_cell_rho(rho_tab(tabs, cutsq), p.ncells, g[0], g[1], g[2], prd)
    # fp = F'(rho) per row: a small elementwise pass between the sweeps
    fp = embedding_fp(tabs, rho.reshape(-1), state.valid_mask)
    gfp = fp.to(dt).reshape(ntot, cc)
    f = eam_cell_force(force_tab(tabs, cutsq), p.ncells, g[0], g[1], g[2],
                       gfp, prd)
    return f.reshape(3, cap).t().contiguous()
