"""Pair style zbl (one atom type): the Ziegler-Biersack-Littmark screened
nuclear repulsion, with LAMMPS's switch between the inner and the outer
cutoff (ref: src/pair_zbl.cpp compute, set_coeff, e_zbl, dzbldr,
d2zbldr2; constants src/pair_zbl_const.h).

Port of `lammps_kokkos_port_tpu/models/pair_zbl.py` for one type:

    E(r) = Zi Zj qqr2e qe^2 / r sum_k c_k exp(-d_k r / a) + S(r),
    a = 0.46850 / (Zi^0.23 + Zj^0.23),

S a polynomial in r - r_inner above the inner cutoff (sw1-sw4) plus the
shift sw5, which takes E, E' and E'' to 0 at the outer cutoff. The style
is a parameter record: host floats passed to the kernel by value. It runs
in list mode "sorted" alone, on a short list of each row's neighbours
within the outer cutoff (ops/snap_kernels.compute_zbl; under
hybrid/overlay the overlay's list).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

from ..ops import snap_kernels
from .pair import ForcePaths

PZBL = 0.23
A0 = 0.46850
CS = snap_kernels.ZBL_CS
DS = (0.20162, 0.40290, 0.94229, 3.19980)


def _series(r, d, zze, order):
    """e_zbl (order 0), dzbldr (1) or d2zbldr2 (2) at r."""
    rinv = 1.0 / r
    s = sum(c * math.exp(-di * r) for c, di in zip(CS, d))
    sp = sum(-c * di * math.exp(-di * r) for c, di in zip(CS, d))
    spp = sum(c * di * di * math.exp(-di * r) for c, di in zip(CS, d))
    if order == 0:
        return zze * s * rinv
    if order == 1:
        return zze * (sp - s * rinv) * rinv
    return zze * (spp - 2.0 * sp * rinv + 2.0 * s * rinv * rinv) * rinv


@dataclasses.dataclass(frozen=True)
class PairZBL:
    """One type pair's ZBL numbers, as set_coeff derives them."""

    cut_inner: float
    cut_global: float
    zi: float
    zj: float
    d: tuple        # d_k / a
    zze: float      # Zi Zj qqr2e qelectron^2
    sw: tuple       # sw1 .. sw5

    force_paths: ClassVar[ForcePaths] = ForcePaths(
        {"sorted": snap_kernels.compute_zbl})
    # under hybrid/overlay (models/forcefield.HybridOverlay): the pass on
    # a shared short list, the span's name, the order of the readers
    short_terms: ClassVar = staticmethod(snap_kernels.zbl_terms)
    trace_name: ClassVar[str] = "zbl"
    short_rank: ClassVar[int] = 1

    def max_cutoff(self) -> float:
        return self.cut_global

    def kernel_params(self) -> tuple:
        """cut_inner, cut_global^2, d1a-d4a, zze, sw1-sw5."""
        return (self.cut_inner, self.cut_global ** 2, *self.d, self.zze,
                *self.sw)


def make_zbl(ntypes: int, cut_inner: float, cut_global: float,
             coeffs: list, units) -> PairZBL:
    """pair_style zbl inner outer; pair_coeff I J Zi Zj for one type
    (coeffs: the pair_coeff words after I J; units: the run's
    utils/units system, whose qqr2e and qelectron scale the charge)."""
    if ntypes != 1:
        raise NotImplementedError(f"zbl with {ntypes} atom types: only one "
                                  "atom type is ported")
    if not 0.0 < cut_inner <= cut_global:
        raise ValueError(f"zbl cutoffs {cut_inner} {cut_global}: need 0 < "
                         "inner <= outer")
    if len(coeffs) != 2:
        raise ValueError("pair_coeff I J zbl takes Zi Zj")
    zi, zj = float(coeffs[0]), float(coeffs[1])
    if zi != zj:
        raise ValueError(f"one atom type takes Zi = Zj, got {zi} {zj}")
    ainv = (zi ** PZBL + zj ** PZBL) / A0
    d = tuple(di * ainv for di in DS)
    zze = zi * zj * units.qqr2e * units.qelectron ** 2
    tc = cut_global - cut_inner
    fc = _series(cut_global, d, zze, 0)
    fcp = _series(cut_global, d, zze, 1)
    fcpp = _series(cut_global, d, zze, 2)
    swa = (-3.0 * fcp + tc * fcpp) / (tc * tc)
    swb = (2.0 * fcp - tc * fcpp) / (tc * tc * tc)
    swc = -fc + (tc / 2.0) * fcp - (tc * tc / 12.0) * fcpp
    return PairZBL(cut_inner=float(cut_inner), cut_global=float(cut_global),
                   zi=zi, zj=zj, d=d, zze=zze,
                   sw=(swa, swb, swa / 3.0, swb / 4.0, swc))
