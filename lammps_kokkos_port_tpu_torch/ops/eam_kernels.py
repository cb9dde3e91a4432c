"""The two dense-EAM cell sweeps: CUDA for Hopper, plus their plain twins.

Port of `lammps_kokkos_port_tpu/ops/pallas_eam.py`. Its two Pallas TPU
kernels, and the fp glue XLA ran between them, become two CUDA kernels in
`csrc/eam_cell.cu`:

  `rho_pallas` (pallas_eam.py:200) and the glue fp = F'(rho)
  (pallas_eam.py:253-260)            -> `eam_cell_rho_fp` (and
      `eam_cell_rho`, the same kernel without its fp epilogue):
      rho_i = sum_j g(u_ij), u = r^2, fp_i = F'(rho_i);
  `force_pallas` (pallas_eam.py:219) -> `eam_cell_force`:
      f_i = sum_j dx_ij * fpair, fpair = -((fp_i + fp_j) a(u) + b(u)),

with g, a, b the Chebyshev fits of ops/eamdense, evaluated by Clenshaw on
u clamped to the fits' range, and F' the embedding fit of `embedding_fp`.
Both take the full 27-cell stencil (the Pallas kernels are Newton-halved;
see the kernel source for why). `compute_force_sorted` chains them: one
rho+fp launch, one force launch. One kernel pair serves every grid size
(no 300k-row dispatch).

CPU tensors go to the plain PyTorch twins `eam_cell_rho_reference` (then
`embedding_fp`) and `eam_cell_force_reference`; CUDA tensors go to the
kernels, built with nvcc at first use (ops/cuda_build), or raise. Every
launch of a kernel adds one to its counter: `eam_cell_rho.launches` (from
either rho wrapper) and `eam_cell_force.launches`. The kernels skip pad
rows by position, which needs a cutoff below the pad spacing: on a CUDA
tensor both wrappers raise otherwise (`pair_kernels.check_pad_cutoff`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .eamdense import clenshaw, embedding_fp
from .pair_kernels import (check_grid, check_launch, check_pad_cutoff,
                           stencil, walk_launch)

SOURCE = cuda_build.CSRC / "eam_cell.cu"
NG = 29   # g coefficients the kernel takes (ops/eamdense.DEG + 1)
NAB = 28  # a and b coefficients (derivative series)
NFP = 80  # Fp_s coefficients (derivative series of the DEG_EMBED fit)


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


def fp_tab(tabs: dict) -> tuple:
    """(Fp_s coefficients, rho_lo, rho_hi, s_lo, s_hi): the constants of
    fp = F'(rho), as `embedding_fp` reads them from the tables."""
    rho_lo, rho_hi = tabs["rho_range"]
    s_lo, s_hi = tabs["s_range"]
    return (tuple(float(c) for c in tabs["Fp_s"]), float(rho_lo),
            float(rho_hi), float(s_lo), float(s_hi))


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


def eam_cell_rho_fp_reference(tab, ftab, ncells, gx, gy, gz, valid, prd):
    """The fused sweep's plain twin: `eam_cell_rho_reference`, then
    `embedding_fp` (0 where `valid` is false). Returns (rho, fp), each
    [ncells, cc]."""
    rho = eam_cell_rho_reference(tab, ncells, gx, gy, gz, prd)
    coeffs, rho_lo, rho_hi, s_lo, s_hi = ftab
    fp = embedding_fp({"Fp_s": coeffs, "rho_range": (rho_lo, rho_hi),
                       "s_range": (s_lo, s_hi)}, rho,
                      valid.reshape(rho.shape))
    return rho, fp


_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_DBL = ctypes.POINTER(ctypes.c_double)
# the C entry points' argument types, <stem>_f32 and <stem>_f64 alike
ARGTYPES = {
    "eam_cell_rho": ([_PTR] * 7 + [_I32] * 4 + [_DBL] + [_F64] * 3 + [_DBL]
                     + [_F64] * 4 + [_PTR]),
    "eam_cell_force": ([_PTR] * 8 + [_I32] * 4 + [_DBL] * 2 + [_F64] * 3
                       + [_PTR])}


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    for stem, types in ARGTYPES.items():
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"{stem}_{dt}")
            fn.argtypes = types
            fn.restype = _I32
        fn = getattr(lib, f"{stem}_shape")
        fn.argtypes = [_I32, _I32, _PTR]
        fn.restype = _I32
    return lib


def launch_shape(name: str, ncells, dtype) -> dict:
    """The launch `name` ("eam_cell_rho" or "eam_cell_force") makes on the
    grid `ncells` in `dtype` (builds the library)."""
    nx, ny, nz = ncells
    return walk_launch(_library(), name, nx * ny * nz, dtype)


def _coeffs(c, n: int, name: str):
    if len(c) != n:
        raise ValueError(f"the kernel takes {n} {name} coefficients, got "
                         f"{len(c)}")
    return (ctypes.c_double * n)(*c)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_valid(valid, gx):
    if (valid.dtype != torch.bool or valid.device != gx.device
            or valid.numel() != gx.numel()):
        raise ValueError("valid must be a bool mask with one entry per grid "
                         "row, on the grid's device")


def _rho_launch(tab, ftab, ncells, gx, gy, gz, valid, prd):
    """One launch of the rho sweep; with `ftab` its fp epilogue too.
    Returns (rho, fp or None)."""
    check_launch((gx, gy, gz), prd)
    g_c, u_lo, u_hi, cutsq = tab
    check_pad_cutoff(cutsq)
    g_arr = _coeffs(g_c, NG, "g")
    rho = torch.empty_like(gx)
    fp = fp_arr = valid_ptr = None
    fp_consts = (0.0,) * 4
    if ftab is not None:
        fp_arr = _coeffs(ftab[0], NFP, "Fp_s")
        fp_consts = ftab[1:]
        valid = valid.reshape(gx.shape).contiguous()
        valid_ptr = valid.data_ptr()
        fp = torch.empty_like(gx)
    fn = (_library().eam_cell_rho_f32 if gx.dtype == torch.float32
          else _library().eam_cell_rho_f64)
    with torch.cuda.device(gx.device):
        err = fn(gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), prd.data_ptr(),
                 valid_ptr, rho.data_ptr(),
                 None if fp is None else fp.data_ptr(), *ncells,
                 gx.shape[1], g_arr, u_lo, u_hi, cutsq, fp_arr, *fp_consts,
                 _stream(gx))
    if err != 0:
        raise RuntimeError(f"eam_cell_rho launch failed: CUDA error {err}")
    eam_cell_rho.launches += 1
    return rho, fp


def eam_cell_rho(tab, ncells, gx, gy, gz, prd):
    """EAM density of every row of the cell-major grid.

    tab: `rho_tab(...)`; ncells: the (nx, ny, nz) grid, each >= 3; gx, gy,
    gz: [nx*ny*nz, cc] positions with cell id (cx*ny+cy)*nz+cz; prd: [3]
    box lengths. Returns rho [ncells, cc]. On a CUDA tensor it launches the
    rho sweep without its fp epilogue, adding one to
    `eam_cell_rho.launches`.
    """
    check_grid(ncells, (gx, gy, gz), prd)
    if gx.device.type == "cpu":
        return eam_cell_rho_reference(tab, ncells, gx, gy, gz, prd)
    return _rho_launch(tab, None, ncells, gx, gy, gz, None, prd)[0]


def eam_cell_rho_fp(tab, ftab, ncells, gx, gy, gz, valid, prd):
    """EAM density and fp = F'(rho) of every row, in one sweep.

    tab: `rho_tab(...)`; ftab: `fp_tab(...)`; valid: bool, one entry per
    row (the state's `valid_mask`): fp is 0 where it is false; the rest as
    `eam_cell_rho`. Returns (rho, fp), each [ncells, cc]. On a CUDA tensor
    it launches the rho sweep with its fp epilogue, adding one to
    `eam_cell_rho.launches`.
    """
    check_grid(ncells, (gx, gy, gz), prd)
    _check_valid(valid, gx)
    if gx.device.type == "cpu":
        return eam_cell_rho_fp_reference(tab, ftab, ncells, gx, gy, gz, valid,
                                         prd)
    return _rho_launch(tab, ftab, ncells, gx, gy, gz, valid, prd)


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
    check_pad_cutoff(cutsq)
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
    """Force-only dense EAM on a SortedCells state through the two sweeps:
    rho and fp = F'(rho) in one, then the forces. Returns f [cap, 3] in the
    sorted layout."""
    from .sortedforce import planar

    p = cl.params
    ntot, cc = p.total_cells, p.cell_cap
    cap = state.capacity
    dt = state.dtype
    g = planar(state.x).reshape(3, ntot, cc)
    prd = state.box.prd.to(dt)
    cutsq = float(style.cutmax) ** 2

    _, gfp = eam_cell_rho_fp(rho_tab(tabs, cutsq), fp_tab(tabs), p.ncells,
                             g[0], g[1], g[2], state.valid_mask, prd)
    f = eam_cell_force(force_tab(tabs, cutsq), p.ncells, g[0], g[1], g[2],
                       gfp, prd)
    return f.reshape(3, cap).t().contiguous()
