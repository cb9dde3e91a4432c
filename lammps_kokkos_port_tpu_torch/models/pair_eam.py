"""Pair style eam (funcfl): embedded-atom many-body potential.

Port of `lammps_kokkos_port_tpu/models/pair_eam.py` (ref:
src/MANYBODY/pair_eam.cpp:533-720 file2array, :769-799 interpolate). The
spline tables are built on the host in numpy exactly as the JAX package
builds them ([n+1, 7] rows, 1-based, the reference's layout) and held as
tensors of the run's dtype.

This slice ports the dense two-pass path (ops/eamdense + the CUDA sweeps
of ops/eam_kernels), which resamples these tables into Chebyshev fits
once per style (`PairEAM.poly_tables`). The exact-spline matrix path
(`PairEAM.compute`) and `make_eam_setfl` belong to a later slice and
raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..io.eam_reader import Funcfl, read_funcfl


def _interpolate(n: int, delta: float, f: np.ndarray) -> np.ndarray:
    """Build the 7-coeff spline table (ref: PairEAM::interpolate).

    f: [n] values (0-based input); returns [n+1, 7] with rows 1..n used,
    matching the reference's 1-based indexing exactly.
    """
    sp = np.zeros((n + 1, 7))
    sp[1:, 6] = f

    sp[1, 5] = sp[2, 6] - sp[1, 6]
    sp[2, 5] = 0.5 * (sp[3, 6] - sp[1, 6])
    sp[n - 1, 5] = 0.5 * (sp[n, 6] - sp[n - 2, 6])
    sp[n, 5] = sp[n, 6] - sp[n - 1, 6]
    m = np.arange(3, n - 1)
    sp[m, 5] = ((sp[m - 2, 6] - sp[m + 2, 6])
                + 8.0 * (sp[m + 1, 6] - sp[m - 1, 6])) / 12.0

    m = np.arange(1, n)
    sp[m, 4] = 3.0 * (sp[m + 1, 6] - sp[m, 6]) - 2.0 * sp[m, 5] - sp[m + 1, 5]
    sp[m, 3] = sp[m, 5] + sp[m + 1, 5] - 2.0 * (sp[m + 1, 6] - sp[m, 6])
    sp[n, 4] = 0.0
    sp[n, 3] = 0.0

    sp[1:, 2] = sp[1:, 5] / delta
    sp[1:, 1] = 2.0 * sp[1:, 4] / delta
    sp[1:, 0] = 3.0 * sp[1:, 3] / delta
    return sp


def _lagrange_resample(src: np.ndarray, src_delta: float, n_out: int,
                       out_delta: float) -> np.ndarray:
    """4-point Lagrange resample onto a common grid (ref: file2array).

    src: [n_src] 0-based values; returns [n_out] values at r = (m-1)*out_delta
    for m=1..n_out, using the reference's clamped-index cubic interpolation.
    """
    n_src = len(src)
    s = np.concatenate([[0.0], src])  # 1-based view
    m = np.arange(1, n_out + 1)
    r = (m - 1) * out_delta
    p = r / src_delta + 1.0
    k = np.floor(p).astype(int)
    k = np.minimum(k, n_src - 2)
    k = np.maximum(k, 2)
    p = np.minimum(p - k, 2.0)
    sixth = 1.0 / 6.0
    cof1 = -sixth * p * (p - 1.0) * (p - 2.0)
    cof2 = 0.5 * (p * p - 1.0) * (p - 2.0)
    cof3 = -0.5 * p * (p + 1.0) * (p - 2.0)
    cof4 = sixth * p * (p * p - 1.0)
    return cof1 * s[k - 1] + cof2 * s[k] + cof3 * s[k + 1] + cof4 * s[k + 2]


@dataclasses.dataclass(frozen=True, eq=False)
class PairEAM:
    """Spline tables and type maps, field for field the JAX PairEAM.
    Compared by identity (eq=False): `poly_tables` is cached on the
    instance."""

    frho_spline: torch.Tensor  # [nfrho, nrho+1, 7]
    rhor_spline: torch.Tensor  # [nrhor, nr+1, 7]
    z2r_spline: torch.Tensor  # [nz2r, nr+1, 7]
    type2frho: torch.Tensor  # [ntypes+1] int32
    type2rhor: torch.Tensor  # [ntypes+1, ntypes+1] int32
    type2z2r: torch.Tensor  # [ntypes+1, ntypes+1] int32
    cutsq: torch.Tensor  # [ntypes+1, ntypes+1]
    ntypes: int
    nrho: int
    nr: int
    drho: float
    dr: float
    rhomax: float
    cutmax: float

    def cutsq_table(self) -> torch.Tensor:
        return self.cutsq

    def max_cutoff(self) -> float:
        return self.cutmax

    @property
    def dense_two_pass(self) -> bool:
        """Single-element styles take the dense path (ops/eamdense:
        Chebyshev-resampled tables, two cell sweeps)."""
        return self.ntypes == 1

    @functools.cached_property
    def poly_tables(self) -> dict:
        """The dense path's Chebyshev tables, built on the host once per
        style (ops/eamdense.build_poly_tables), never in the step loop."""
        from ..ops import eamdense

        return eamdense.build_poly_tables(self)

    def compute(self, state, nl, eflag: bool, vflag: bool):
        raise NotImplementedError(
            "the exact-spline EAM matrix path is not ported yet (slice 6, "
            "with the [N,K] matrix engine); run the dense path with "
            "list_mode='sorted'")


def make_eam_funcfl(
    ntypes: int,
    files: dict[int, str | Funcfl],
    dtype: torch.dtype = torch.float64,
    device="cpu",
) -> PairEAM:
    """`pair_style eam` + per-type `pair_coeff i i file` (funcfl).

    files maps 1-based type -> funcfl path (or parsed Funcfl). Mixing between
    elements follows the reference: z2r_ij = 27.2*0.529 * Z_i(r) Z_j(r)
    (ref: file2array).
    """
    parsed: list[Funcfl] = []
    keys = {}
    for t in range(1, ntypes + 1):
        if t not in files:
            raise ValueError(f"no EAM funcfl file for type {t}")
        f = files[t]
        key = f if isinstance(f, str) else id(f)
        if key not in keys:
            keys[key] = len(parsed)
            parsed.append(read_funcfl(f) if isinstance(f, str) else f)
    type_map = np.array(
        [0] + [keys[files[t] if isinstance(files[t], str) else id(files[t])]
               for t in range(1, ntypes + 1)],
        dtype=np.int32,
    )
    nfiles = len(parsed)

    # common grid (ref: file2array): max spacings, counts from max extents
    dr = max(f.dr for f in parsed)
    drho = max(f.drho for f in parsed)
    rmax = max((f.nr - 1) * f.dr for f in parsed)
    rhomax = max((f.nrho - 1) * f.drho for f in parsed)
    nr = int(rmax / dr + 0.5)
    nrho = int(rhomax / drho + 0.5)

    frho = np.zeros((nfiles + 1, nrho))  # extra zero row for non-EAM types
    rhor = np.zeros((nfiles, nr))
    for i, f in enumerate(parsed):
        frho[i] = _lagrange_resample(f.frho, f.drho, nrho, drho)
        rhor[i] = _lagrange_resample(f.rhor, f.dr, nr, dr)

    nz2r = nfiles * (nfiles + 1) // 2
    z2r = np.zeros((nz2r, nr))
    n = 0
    zr_res = [_lagrange_resample(f.zr, f.dr, nr, dr) for f in parsed]
    for i in range(nfiles):
        for jj in range(i + 1):
            z2r[n] = 27.2 * 0.529 * zr_res[i] * zr_res[jj]
            n += 1

    # type maps (ref: file2array type2frho/type2rhor/type2z2r)
    type2frho = type_map.copy()
    type2rhor = np.zeros((ntypes + 1, ntypes + 1), dtype=np.int32)
    type2z2r = np.zeros((ntypes + 1, ntypes + 1), dtype=np.int32)
    for i in range(1, ntypes + 1):
        for jt in range(1, ntypes + 1):
            type2rhor[i, jt] = type_map[i]
            irow, icol = type_map[i], type_map[jt]
            if irow < icol:
                irow, icol = icol, irow
            type2z2r[i, jt] = irow * (irow + 1) // 2 + icol

    cutmax = max(f.cut for f in parsed)
    cutsq = np.full((ntypes + 1, ntypes + 1), cutmax * cutmax)

    return _finalize_eam(
        ntypes, nrho, nr, drho, dr, rhomax, cutmax, cutsq,
        frho, rhor, z2r, type2frho, type2rhor, type2z2r, dtype, device,
    )


def make_eam_setfl(*args, **kwargs) -> PairEAM:
    """`pair_style eam/alloy` / `eam/fs`: not ported yet."""
    raise NotImplementedError(
        "eam/alloy and eam/fs (setfl) are not ported yet (slice 6)")


def _finalize_eam(
    ntypes, nrho, nr, drho, dr, rhomax, cutmax, cutsq,
    frho, rhor, z2r, type2frho, type2rhor, type2z2r, dtype, device,
) -> PairEAM:
    def tab(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return PairEAM(
        frho_spline=tab(np.stack([_interpolate(nrho, drho, t)
                                  for t in frho])),
        rhor_spline=tab(np.stack([_interpolate(nr, dr, t) for t in rhor])),
        z2r_spline=tab(np.stack([_interpolate(nr, dr, t) for t in z2r])),
        type2frho=tab(type2frho, torch.int32),
        type2rhor=tab(type2rhor, torch.int32),
        type2z2r=tab(type2z2r, torch.int32),
        cutsq=tab(cutsq),
        ntypes=ntypes,
        nrho=nrho,
        nr=nr,
        drho=float(drho),
        dr=float(dr),
        rhomax=float(rhomax),
        cutmax=float(cutmax),
    )
