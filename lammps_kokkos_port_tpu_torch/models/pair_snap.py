"""Pair style snap (one element): the SNAP bispectrum potential.

Port of `lammps_kokkos_port_tpu/models/pair_snap.py` for one element (ref:
src/ML-SNAP/pair_snap.cpp read_files, coeff; sna.cpp init_clebsch_gordan,
build_indexlist, compute_uarray, compute_bi). The JAX package takes the
forces as jax.grad of the energy; the port computes them as Kokkos's
pipeline does (src/KOKKOS/pair_snap_kokkos_impl.h), in the CUDA kernels
of ops/snap_kernels, with no autograd on the step path:

    U_i     = wself I + sum_j sfac(r_ij) wj u(r_ij)   (Wigner U, j <= twojmax)
    B_i,b   = sum_t w_t Re[U_i,u1 U_i,u2 conj(U_i,u3)]  (- bzero where set)
    E_i     = beta_0 + sum_b beta_b B_i,b
    Y_i     = dE_i / dU_i              (ui, then yi: once an atom)
    F       = sum over pairs of Re[conj(Y_i) dU_i/dr_ij]   (deidrj)

The host code here is numpy alone (copied into the port, as ROADMAP's
north star says of host code): the Clebsch-Gordan list and the bispectrum
as one flat trilinear table (`bispectrum_terms`, the JAX package's
`build_snap_tables`: LAMMPS's zi and bi loops replayed symbolically), and
from it the table of Y (`y_table`): each trilinear term's three partial
derivatives, folded onto the left half of each U_j by its symmetry
U[j-mb][j-ma] = (-1)^(ma+mb) conj(U[mb][ma]), with beta folded in.

The half (`half_index`): for each j the rows mb <= j/2, every ma; U, Y and
the kernels' per-row planes hold these `nhalf` entries (155 at twojmax 8)
as (re, im) pairs. Since every term is trilinear, E_i - E_0 = 1/3 sum over
the half of Re[conj(Y) U] (Euler's theorem), which the thermo rows use.

quadraticflag, chemflag, bnormflag, wselfallflag and switchinnerflag
other than their defaults raise NotImplementedError, as do more than one
element or atom type.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import ClassVar

import numpy as np

from ..ops import snap_kernels
from .pair import ForcePaths

# LAMMPS's defaults of the .snapparam keywords (PairSNAP::read_files)
PARAM_DEFAULTS = {"rfac0": 0.99363, "rmin0": 0.0, "switchflag": 1,
                  "bzeroflag": 1, "quadraticflag": 0, "chemflag": 0,
                  "bnormflag": 0, "wselfallflag": 0, "switchinnerflag": 0}
# the keywords whose non-default values are not ported
NOT_PORTED = ("quadraticflag", "chemflag", "bnormflag", "wselfallflag",
              "switchinnerflag")


# ---- files -----------------------------------------------------------------

def _lines(path: str) -> list[str]:
    with open(path) as f:
        out = [ln.split("#")[0].strip() for ln in f]
    return [ln for ln in out if ln]


def read_snapcoeff(path: str) -> dict:
    """{element: (radelem, wj, coefficients)} of a .snapcoeff file."""
    lines = _lines(path)
    nelem, ncoeff = (int(t) for t in lines[0].split()[:2])
    out, pos = {}, 1
    for _ in range(nelem):
        name, rad, wj = lines[pos].split()[:3]
        coeffs = [float(lines[pos + 1 + k].split()[0]) for k in range(ncoeff)]
        out[name] = (float(rad), float(wj), coeffs)
        pos += 1 + ncoeff
    return out


def read_snapparam(path: str) -> dict:
    """The keywords of a .snapparam file over LAMMPS's defaults."""
    params = dict(PARAM_DEFAULTS)
    for ln in _lines(path):
        key, val = ln.split()[:2]
        params[key] = float(val) if key in ("rcutfac", "rfac0",
                                            "rmin0") else int(float(val))
    for key in ("rcutfac", "twojmax"):
        if key not in params:
            raise ValueError(f"{path}: no {key}")
    return params


# ---- index and coefficient tables ------------------------------------------

def _fact(n: int) -> float:
    return float(math.factorial(n))


def _deltacg(j1, j2, j):
    return math.sqrt(_fact((j1 + j2 - j) // 2) * _fact((j1 - j2 + j) // 2)
                     * _fact((-j1 + j2 + j) // 2)
                     / _fact((j1 + j2 + j) // 2 + 1))


def clebsch_gordan(twojmax: int):
    """(cglist, block offset by (j1, j2, j)): SNA::init_clebsch_gordan."""
    cg, block = [], {}
    for j1 in range(twojmax + 1):
        for j2 in range(j1 + 1):
            for j in range(j1 - j2, min(twojmax, j1 + j2) + 1, 2):
                block[(j1, j2, j)] = len(cg)
                for m1 in range(j1 + 1):
                    aa2 = 2 * m1 - j1
                    for m2 in range(j2 + 1):
                        bb2 = 2 * m2 - j2
                        m = (aa2 + bb2 + j) // 2
                        if m < 0 or m > j:
                            cg.append(0.0)
                            continue
                        total = 0.0
                        zmin = max(0, max(-(j - j2 + aa2) // 2,
                                          -(j - j1 - bb2) // 2))
                        zmax = min((j1 + j2 - j) // 2,
                                   min((j1 - aa2) // 2, (j2 + bb2) // 2))
                        for z in range(zmin, zmax + 1):
                            total += (-1.0 if z % 2 else 1.0) / (
                                _fact(z) * _fact((j1 + j2 - j) // 2 - z)
                                * _fact((j1 - aa2) // 2 - z)
                                * _fact((j2 + bb2) // 2 - z)
                                * _fact((j - j2 + aa2) // 2 + z)
                                * _fact((j - j1 - bb2) // 2 + z))
                        cc2 = 2 * m - j
                        sfac = math.sqrt(
                            _fact((j1 + aa2) // 2) * _fact((j1 - aa2) // 2)
                            * _fact((j2 + bb2) // 2) * _fact((j2 - bb2) // 2)
                            * _fact((j + cc2) // 2) * _fact((j - cc2) // 2)
                            * (j + 1))
                        cg.append(total * _deltacg(j1, j2, j) * sfac)
    return np.asarray(cg), block


def idxu_block(twojmax: int) -> list[int]:
    """Offset of each U_j in the full list ((j+1)^2 entries each)."""
    return [sum((k + 1) ** 2 for k in range(j)) for j in range(twojmax + 1)]


def idxb(twojmax: int) -> list[tuple[int, int, int]]:
    """The bispectrum components (j1, j2, j), j >= j1 (LAMMPS's order)."""
    return [(j1, j2, j) for j1 in range(twojmax + 1)
            for j2 in range(j1 + 1)
            for j in range(j1 - j2, min(twojmax, j1 + j2) + 1, 2) if j >= j1]


@functools.cache
def half_index(twojmax: int):
    """(full index of each half entry [nhalf], half index of each full
    entry [nfull] or -1): the half is, for each j, the rows mb <= j/2 and
    every ma, in (j, mb, ma) order."""
    blocks = idxu_block(twojmax)
    full_of, half_of = [], []
    for j in range(twojmax + 1):
        for mb in range(j + 1):
            for ma in range(j + 1):
                if 2 * mb <= j:
                    half_of.append(len(full_of))
                    full_of.append(blocks[j] + mb * (j + 1) + ma)
                else:
                    half_of.append(-1)
    return np.asarray(full_of), np.asarray(half_of)


def mirror(twojmax: int):
    """For each full entry (j, mb, ma): the full index of (j, j-mb, j-ma)
    and the sign (-1)^(ma+mb) of U[j-mb][j-ma] = s conj(U[mb][ma])."""
    blocks = idxu_block(twojmax)
    partner, sign = [], []
    for j in range(twojmax + 1):
        for mb in range(j + 1):
            for ma in range(j + 1):
                partner.append(blocks[j] + (j - mb) * (j + 1) + (j - ma))
                sign.append(-1.0 if (ma + mb) % 2 else 1.0)
    return np.asarray(partner), np.asarray(sign)


@functools.cache
def bispectrum_terms(twojmax: int):
    """The bispectrum as one flat trilinear table: B_b = sum over the terms
    t of b of w_t Re[U_u1 U_u2 conj(U_u3)], u1..u3 full indices (the JAX
    package's build_snap_tables: LAMMPS's compute_zi loop nest, with
    compute_bi's weights over the half of U_j, 2 off the middle row, 2 left
    of its middle, 1 at it). Returns (u1, u2, u3, b, w)."""
    blocks = idxu_block(twojmax)
    cglist, cgblock = clebsch_gordan(twojmax)
    t_u1, t_u2, t_u3, t_b, t_w = [], [], [], [], []
    for jjb, (j1, j2, j) in enumerate(idxb(twojmax)):
        cgoff = cgblock[(j1, j2, j)]
        for mb in range(j // 2 + 1):
            for ma in range(j + 1):
                if 2 * mb < j or ma < mb:
                    w_u = 2.0
                elif ma == mb:
                    w_u = 1.0
                else:
                    continue
                ma1min = max(0, (2 * ma - j - j2 + j1) // 2)
                ma2max = (2 * ma - j - (2 * ma1min - j1) + j2) // 2
                na = min(j1, (2 * ma - j + j2 + j1) // 2) - ma1min + 1
                mb1min = max(0, (2 * mb - j - j2 + j1) // 2)
                mb2max = (2 * mb - j - (2 * mb1min - j1) + j2) // 2
                nb = min(j1, (2 * mb - j + j2 + j1) // 2) - mb1min + 1
                jju = blocks[j] + (j + 1) * mb + ma
                jju1 = blocks[j1] + (j1 + 1) * mb1min
                jju2 = blocks[j2] + (j2 + 1) * mb2max
                icgb = mb1min * (j2 + 1) + mb2max
                for _ in range(nb):
                    ma1, ma2 = ma1min, ma2max
                    icga = ma1min * (j2 + 1) + ma2max
                    for _ in range(na):
                        w = w_u * cglist[cgoff + icgb] * cglist[cgoff + icga]
                        if w != 0.0:
                            t_u1.append(jju1 + ma1)
                            t_u2.append(jju2 + ma2)
                            t_u3.append(jju)
                            t_b.append(jjb)
                            t_w.append(w)
                        ma1 += 1
                        ma2 -= 1
                        icga += j2
                    jju1 += j1 + 1
                    jju2 -= j2 + 1
                    icgb += j2
    return (np.asarray(t_u1), np.asarray(t_u2), np.asarray(t_u3),
            np.asarray(t_b), np.asarray(t_w))


# bits of a Y table entry: a (9), b (9), conj a (bit 18), conj b (bit 19),
# the output (from bit 20)
_A_BITS, _OUT_SHIFT = 9, 20


def y_table(twojmax: int, beta: np.ndarray):
    """The table of Y = dE/dU on the half: (entries int32 [E], coef
    float64 [E]), sorted by their output. Entry e adds coef_e op_a(U_a)
    op_b(U_b) to Y[out_e] (a, b full indices, op the identity or conj, out
    a half index), packed as a | b << 9 | conj_a << 18 | conj_b << 19 |
    out << 20.

    From each term c = beta_b w_t of E, its partial derivatives (with Y
    such that dE = sum Re[conj(Y) dU]): conj(U_u2) U_u3 at u1, conj(U_u1)
    U_u3 at u2, U_u1 U_u2 at u3. A derivative at a full entry outside the
    half lands, conjugated and times its sign, on its mirror in the half.
    Equal entries are merged; a symmetric product takes a <= b."""
    u1, u2, u3, b, w = bispectrum_terms(twojmax)
    c = np.asarray(beta, dtype=np.float64)[b] * w
    _, half_of = half_index(twojmax)
    partner, sign = mirror(twojmax)
    parts = [(u1, u2, u3, 1, 0), (u2, u1, u3, 1, 0), (u3, u1, u2, 0, 0)]
    outs, aa, bb, ca, cb, cc = [], [], [], [], [], []
    for out, a, bidx, conj_a, conj_b in parts:
        h = half_of[out]
        inside = h >= 0
        # outside the half: conj and the sign, onto the mirror
        hh = np.where(inside, h, half_of[partner[out]])
        outs.append(hh)
        aa.append(a)
        bb.append(bidx)
        ca.append(np.where(inside, conj_a, 1 - conj_a))
        cb.append(np.where(inside, conj_b, 1 - conj_b))
        cc.append(np.where(inside, c, c * sign[out]))
    out = np.concatenate(outs)
    a = np.concatenate(aa)
    bidx = np.concatenate(bb)
    conj_a = np.concatenate(ca)
    conj_b = np.concatenate(cb)
    coef = np.concatenate(cc)
    # a symmetric product (both or neither conjugated) in one order
    sym = conj_a == conj_b
    lo, hi = np.minimum(a, bidx), np.maximum(a, bidx)
    a = np.where(sym, lo, a)
    bidx = np.where(sym, hi, bidx)
    packed = (a | (bidx << _A_BITS) | (conj_a << 18) | (conj_b << 19)
              | (out << _OUT_SHIFT)).astype(np.int64)
    keys, inv = np.unique(packed, return_inverse=True)
    summed = np.zeros(keys.size)
    np.add.at(summed, inv, coef)
    keep = summed != 0.0
    keys, summed = keys[keep], summed[keep]
    order = np.argsort(keys >> _OUT_SHIFT, kind="stable")
    return keys[order].astype(np.int32), summed[order]


# ---- the style -------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class PairSNAP:
    """One element's SNAP potential (the .snapcoeff / .snapparam numbers)."""

    element: str
    twojmax: int
    rcutfac: float
    rfac0: float
    rmin0: float
    radelem: float
    wj: float
    switchflag: int
    bzeroflag: int
    beta0: float
    beta: tuple        # the linear coefficients, one per idxb component

    force_paths: ClassVar[ForcePaths] = ForcePaths(
        {"sorted": snap_kernels.compute})
    # under hybrid/overlay (models/forcefield.HybridOverlay): the pass on
    # a shared short list, the span's name, the order of the readers
    short_terms: ClassVar = staticmethod(snap_kernels.snap_terms)
    trace_name: ClassVar[str] = "snap"
    short_rank: ClassVar[int] = 0

    @property
    def rcut(self) -> float:
        """(radelem_i + radelem_j) rcutfac, one element."""
        return 2.0 * self.radelem * self.rcutfac

    def max_cutoff(self) -> float:
        return self.rcut

    @property
    def nhalf(self) -> int:
        return int(half_index(self.twojmax)[0].size)

    def energy_shift(self) -> float:
        """beta_0, less sum_b beta_b bzero_b where bzeroflag (bzero_b = j +
        1 of component b's j: SNA's bzero with wself 1, bnormflag 0)."""
        if not self.bzeroflag:
            return self.beta0
        return self.beta0 - sum(bt * (j + 1.0) for bt, (_, _, j) in zip(
            self.beta, idxb(self.twojmax)))

    def kernel_params(self) -> tuple:
        """The numbers the kernels and their twins take: twojmax, rcut^2,
        rcut, rfac0, rmin0, wj, wself, switchflag, the energy shift."""
        return (float(self.twojmax), self.rcut ** 2, self.rcut, self.rfac0,
                self.rmin0, self.wj, 1.0, float(self.switchflag),
                self.energy_shift())

    @functools.cached_property
    def table(self):
        """`y_table` of this style's beta."""
        return y_table(self.twojmax, np.asarray(self.beta))


def make_snap(ntypes: int, coeff_path: str, param_path: str,
              elements: list[str]) -> PairSNAP:
    """pair_style snap; pair_coeff * * <coeff> <param> <El> for one type."""
    if ntypes != 1 or len(elements) != 1:
        raise NotImplementedError(
            f"snap with {ntypes} atom types ({' '.join(elements)}): only a "
            "single element is ported")
    params = read_snapparam(param_path)
    for key in NOT_PORTED:
        if params[key] != PARAM_DEFAULTS[key]:
            raise NotImplementedError(f"snap {key} {params[key]} is not "
                                      "ported")
    coeffs = read_snapcoeff(coeff_path)
    if len(coeffs) != 1:
        raise NotImplementedError(f"{coeff_path}: {len(coeffs)} elements; "
                                  "only a single element is ported")
    el = elements[0]
    if el not in coeffs:
        raise ValueError(f"{coeff_path}: no element {el}")
    radelem, wj, c = coeffs[el]
    twojmax = int(params["twojmax"])
    if twojmax % 2 or twojmax < 0:
        raise ValueError(f"snap twojmax must be even and >= 0, got {twojmax}")
    ncoeff = len(idxb(twojmax))
    if len(c) != ncoeff + 1:
        raise ValueError(f"{coeff_path}: {len(c)} coefficients, twojmax "
                         f"{twojmax} takes {ncoeff + 1}")
    return PairSNAP(element=el, twojmax=twojmax,
                    rcutfac=float(params["rcutfac"]),
                    rfac0=float(params["rfac0"]),
                    rmin0=float(params["rmin0"]), radelem=radelem, wj=wj,
                    switchflag=int(params["switchflag"]),
                    bzeroflag=int(params["bzeroflag"]), beta0=c[0],
                    beta=tuple(c[1:]))

