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

Thermo rows (energy and virial) run tally instances of the same two
walks, separate template instantiations under their own kernel names, so
that the step's instances keep their registers, their SASS and their
names (`eam_cell_rho_kernel`, `eam_cell_force_kernel`; no TPU kernel, the
JAX package left the energy pass to XLA):

  `eam_cell_rho_tally` (`eam_cell_rho_tally_kernel`): rho, fp and each
      valid row's embedding energy e_i = F(rho_i) (`embedding_energy`);
  `eam_cell_force_tally` (`eam_cell_force_tally_kernel`): the forces and
      seven planes per row, pe_i = e_i + 1/2 sum_j phi(u) and the virial
      1/2 sum_j fpair dx_a dx_b (xx, yy, zz, xy, xz, yz), halved because
      the 27-cell stencil sees each pair from both rows.

`compute_tally_sorted` chains them and sums the planes over the valid
rows in float64 (`pair_kernels.tally_sums`; no atomics: deterministic).

CPU tensors go to the plain PyTorch twins `eam_cell_rho_reference` (then
`embedding_fp`), `eam_cell_force_reference` and the tally twins
`eam_cell_rho_tally_reference` and `eam_cell_force_tally_reference`;
CUDA tensors go to the kernels, built with nvcc at first use
(ops/cuda_build), or raise. Every launch of a kernel adds one to its
counter: `eam_cell_rho.launches` (from either rho wrapper),
`eam_cell_force.launches`, `eam_cell_rho_tally.launches` and
`eam_cell_force_tally.launches`. The kernels skip pad rows by position,
which needs a cutoff below the pad spacing: on a CUDA tensor every
wrapper raises otherwise (`pair_kernels.check_pad_cutoff`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .eamdense import clenshaw, embedding_energy, embedding_fp
from .pair_kernels import (check_grid, check_launch, check_pad_cutoff,
                           stencil, tally_sums, walk_launch)
from .sortedforce import planar

SOURCE = cuda_build.CSRC / "eam_cell.cu"
NG = 29   # g coefficients the kernel takes (ops/eamdense.DEG + 1)
NAB = 28  # a and b coefficients (derivative series)
NFP = 80  # Fp_s coefficients (derivative series of the DEG_EMBED fit)
NF = 81   # F coefficients (the DEG_EMBED fit; tally only)
NPHI = 29  # phi coefficients (tally only)
# the virial's components (xx, yy, zz, xy, xz, yz) as pairs of axes
VIRIAL_AXES = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


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


def embed_tab(tabs: dict) -> tuple:
    """The F coefficients of the embedding energy (over `fp_tab`'s
    ranges)."""
    return tuple(float(c) for c in tabs["F"])


def phi_tab(tabs: dict) -> tuple:
    """The phi coefficients of the pair energy (over `force_tab`'s u
    range)."""
    return tuple(float(c) for c in tabs["phi"])


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


def _force_sweep(tab, ncells, gx, gy, gz, gfp, prd, phi_c=None):
    """The plain force sweep; with `phi_c` also each row's sums of phi(u)
    and of fpair dx_a dx_b (VIRIAL_AXES), unhalved. Returns (f [3, ncells,
    cc], the 7 sums [7, ncells, cc] or None)."""
    a_c, b_c, u_lo, u_hi, cutsq = tab
    fp_i = gfp.reshape(*ncells, gfp.shape[-1])[..., :, None]
    out = [torch.zeros_like(a) for a in (gx, gy, gz)]
    sums = None if phi_c is None else [torch.zeros_like(gx) for _ in range(7)]
    for d, r2, pair_ok, (fp_j,) in stencil(ncells, gx, gy, gz, prd, (gfp,)):
        valid = r2 < cutsq
        if pair_ok is not None:
            valid = valid & pair_ok
        us = torch.clamp(r2, u_lo, u_hi)
        a = clenshaw(a_c, us, u_lo, u_hi)
        b = clenshaw(b_c, us, u_lo, u_hi)
        fpair = torch.where(valid, -((fp_i + fp_j[..., None, :]) * a + b),
                            0.0)
        terms = [d[dim] * fpair for dim in range(3)]
        if sums is not None:
            terms.append(torch.where(valid, clenshaw(phi_c, us, u_lo, u_hi),
                                     0.0))
            terms.extend(d[i] * fpair * d[j] for i, j in VIRIAL_AXES)
        for acc, term in zip(out + (sums or []), terms):
            acc += torch.sum(term, dim=-1).reshape(acc.shape)
    return torch.stack(out), None if sums is None else torch.stack(sums)


def eam_cell_force_reference(tab, ncells, gx, gy, gz, gfp, prd):
    """Plain PyTorch force sweep with the fp channel `gfp` [ncells, cc].
    Returns [3, ncells, cc] (fx, fy, fz on the leading axis)."""
    return _force_sweep(tab, ncells, gx, gy, gz, gfp, prd)[0]


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


def eam_cell_rho_tally_reference(tab, ftab, etab, ncells, gx, gy, gz, valid,
                                 prd):
    """The rho tally's plain twin: `eam_cell_rho_fp_reference`, then
    `embedding_energy` (0 where `valid` is false). Returns (rho, fp, e),
    each [ncells, cc]."""
    rho, fp = eam_cell_rho_fp_reference(tab, ftab, ncells, gx, gy, gz,
                                        valid, prd)
    _, rho_lo, rho_hi, s_lo, s_hi = ftab
    e = embedding_energy({"F": etab, "rho_range": (rho_lo, rho_hi),
                          "s_range": (s_lo, s_hi)}, rho, fp,
                         valid.reshape(rho.shape))
    return rho, fp, e


def eam_cell_force_tally_reference(tab, phi_c, ncells, gx, gy, gz, gfp, ge,
                                   prd):
    """The force tally's plain twin. Returns (f [3, ncells, cc], tally [7,
    ncells, cc]): tally[0] = ge + 1/2 sum_j phi(u), tally[1:] = 1/2 sum_j
    fpair dx_a dx_b in VIRIAL_AXES order."""
    f, sums = _force_sweep(tab, ncells, gx, gy, gz, gfp, prd, phi_c)
    half = 0.5 * sums
    half[0] += ge
    return f, half


_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_DBL = ctypes.POINTER(ctypes.c_double)
# the C entry points' argument types, <stem>_f32 and <stem>_f64 alike: one
# entry per sweep, which launches the tally instance where its tally
# arguments are not null (rho: e and the F coefficients; force: ge, tally
# and the phi coefficients); each reports its launch shape (`<stem>_shape`;
# the tally instances launch as the sweeps they instantiate)
ARGTYPES = {
    "eam_cell_rho": ([_PTR] * 8 + [_I32] * 4 + [_DBL] + [_F64] * 3 + [_DBL]
                     + [_F64] * 4 + [_DBL, _PTR]),
    "eam_cell_force": ([_PTR] * 10 + [_I32] * 4 + [_DBL] * 3 + [_F64] * 3
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
    for stem in ARGTYPES:
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


def _fn(stem: str, dtype):
    """The C entry point `stem` for `dtype`."""
    return getattr(_library(),
                   f"{stem}_f32" if dtype == torch.float32 else f"{stem}_f64")


def _rho_launch(tab, ftab, ncells, gx, gy, gz, valid, prd, etab=None):
    """One launch of the rho sweep; with `ftab` its fp epilogue too; with
    `etab` (and `ftab`) the tally instance, which also writes the embedding
    energy. Returns (rho, fp or None, e or None)."""
    check_launch((gx, gy, gz), prd)
    g_c, u_lo, u_hi, cutsq = tab
    check_pad_cutoff(cutsq)
    g_arr = _coeffs(g_c, NG, "g")
    rho = torch.empty_like(gx)
    fp = fp_arr = valid_ptr = e = e_arr = None
    fp_consts = (0.0,) * 4
    if ftab is not None:
        fp_arr = _coeffs(ftab[0], NFP, "Fp_s")
        fp_consts = ftab[1:]
        valid = valid.reshape(gx.shape).contiguous()
        valid_ptr = valid.data_ptr()
        fp = torch.empty_like(gx)
    counted = eam_cell_rho
    if etab is not None:
        e = torch.empty_like(gx)
        e_arr = _coeffs(etab, NF, "F")
        counted = eam_cell_rho_tally
    outs = [rho, fp, e]
    with torch.cuda.device(gx.device):
        err = _fn("eam_cell_rho", gx.dtype)(
            gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), prd.data_ptr(),
            valid_ptr, *(None if t is None else t.data_ptr() for t in outs),
            *ncells, gx.shape[1], g_arr, u_lo, u_hi, cutsq, fp_arr,
            *fp_consts, e_arr, _stream(gx))
    if err != 0:
        raise RuntimeError(f"{counted.__name__} launch failed: CUDA error "
                           f"{err}")
    counted.launches += 1
    return rho, fp, e


def _force_launch(tab, ncells, gx, gy, gz, gfp, prd, phi_c=None, ge=None):
    """One launch of the force sweep; with `phi_c` and `ge` the tally
    instance. Returns (f [3, ncells, cc], tally [7, ncells, cc] or
    None)."""
    check_launch([gx, gy, gz, gfp] + ([] if ge is None else [ge]), prd)
    a_c, b_c, u_lo, u_hi, cutsq = tab
    check_pad_cutoff(cutsq)
    ncell, cc = gx.shape
    out = torch.empty((3, ncell, cc), dtype=gx.dtype, device=gx.device)
    tally = phi_arr = None
    counted = eam_cell_force
    if phi_c is not None:
        tally = torch.empty((7, ncell, cc), dtype=gx.dtype, device=gx.device)
        phi_arr = _coeffs(phi_c, NPHI, "phi")
        counted = eam_cell_force_tally
    ptrs = [None if t is None else t.data_ptr()
            for t in (gx, gy, gz, gfp, ge, prd, *out, tally)]
    with torch.cuda.device(gx.device):
        err = _fn("eam_cell_force", gx.dtype)(
            *ptrs, *ncells, cc, _coeffs(a_c, NAB, "a"),
            _coeffs(b_c, NAB, "b"), phi_arr, u_lo, u_hi, cutsq, _stream(gx))
    if err != 0:
        raise RuntimeError(f"{counted.__name__} launch failed: CUDA error "
                           f"{err}")
    counted.launches += 1
    return out, tally


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
    return _rho_launch(tab, ftab, ncells, gx, gy, gz, valid, prd)[:2]


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
    return _force_launch(tab, ncells, gx, gy, gz, gfp, prd)[0]


def eam_cell_rho_tally(tab, ftab, etab, ncells, gx, gy, gz, valid, prd):
    """EAM density, fp = F'(rho) and embedding energy of every row, in one
    sweep (thermo rows).

    etab: `embed_tab(...)`; the rest as `eam_cell_rho_fp`. Returns (rho,
    fp, e), each [ncells, cc]; e = F(rho), extended linearly with slope fp
    above rho_hi, 0 where `valid` is false. On a CUDA tensor it launches
    `eam_cell_rho_tally_kernel`, adding one to
    `eam_cell_rho_tally.launches`.
    """
    check_grid(ncells, (gx, gy, gz), prd)
    _check_valid(valid, gx)
    if gx.device.type == "cpu":
        return eam_cell_rho_tally_reference(tab, ftab, etab, ncells, gx, gy,
                                            gz, valid, prd)
    return _rho_launch(tab, ftab, ncells, gx, gy, gz, valid, prd, etab)


def eam_cell_force_tally(tab, phi_c, ncells, gx, gy, gz, gfp, ge, prd):
    """EAM forces and each row's energy and virial (thermo rows).

    phi_c: `phi_tab(...)`; ge: [nx*ny*nz, cc] each row's embedding energy
    (`eam_cell_rho_tally`'s e); the rest as `eam_cell_force`. Returns (f
    [3, ncells, cc], tally [7, ncells, cc]): tally[0] = ge + 1/2 sum_j
    phi(u), tally[1:] = 1/2 sum_j fpair dx_a dx_b in VIRIAL_AXES order.
    On a CUDA tensor it launches `eam_cell_force_tally_kernel`, adding one
    to `eam_cell_force_tally.launches`.
    """
    check_grid(ncells, (gx, gy, gz, gfp, ge), prd)
    if gx.device.type == "cpu":
        return eam_cell_force_tally_reference(tab, phi_c, ncells, gx, gy, gz,
                                              gfp, ge, prd)
    return _force_launch(tab, ncells, gx, gy, gz, gfp, prd, phi_c, ge)


eam_cell_rho.launches = 0
eam_cell_force.launches = 0
eam_cell_rho_tally.launches = 0
eam_cell_force_tally.launches = 0


def _sorted_grid(style, state, cl):
    """(params, planar grid [3, ncells, cc], prd, cutsq) of a SortedCells
    state."""
    p = cl.params
    g = planar(state.x).reshape(3, p.total_cells, p.cell_cap)
    return p, g, state.box.prd.to(state.dtype), float(style.cutmax) ** 2


def compute_force_sorted(style, tabs, state, cl):
    """Force-only dense EAM on a SortedCells state through the two sweeps:
    rho and fp = F'(rho) in one, then the forces. Returns f [cap, 3] in the
    sorted layout."""
    p, g, prd, cutsq = _sorted_grid(style, state, cl)
    _, gfp = eam_cell_rho_fp(rho_tab(tabs, cutsq), fp_tab(tabs), p.ncells,
                             g[0], g[1], g[2], state.valid_mask, prd)
    f = eam_cell_force(force_tab(tabs, cutsq), p.ncells, g[0], g[1], g[2],
                       gfp, prd)
    return f.reshape(3, state.capacity).t().contiguous()


def compute_tally_sorted(style, tabs, state, cl):
    """Dense EAM with energy and virial on a SortedCells state (thermo
    rows) through the tally instances of the two sweeps. Returns (f [cap,
    3] in the sorted layout, pe, virial [6]), pe and virial as the grid-roll
    path of ops/eamdense defines them (pe = sum_i F(rho_i) + the pair
    energy, each pair once; virial = sum over pairs of fpair dx_a dx_b),
    the valid rows' planes summed (`pair_kernels.tally_sums`), then taken
    to the state's dtype."""
    p, g, prd, cutsq = _sorted_grid(style, state, cl)
    _, gfp, ge = eam_cell_rho_tally(rho_tab(tabs, cutsq), fp_tab(tabs),
                                    embed_tab(tabs), p.ncells, g[0], g[1],
                                    g[2], state.valid_mask, prd)
    f, tally = eam_cell_force_tally(force_tab(tabs, cutsq), phi_tab(tabs),
                                    p.ncells, g[0], g[1], g[2], gfp, ge, prd)
    sums = tally_sums(tally, state.valid_mask).to(state.dtype)
    return f.reshape(3, state.capacity).t().contiguous(), sums[0], sums[1:]

