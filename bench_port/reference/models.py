"""Forces, energy and virial of the decks' pair styles, over a pair list.

`LJ` is `pair_style lj/cut` (unshifted, one type); `EAM` is the dense
Chebyshev form of a single-element funcfl potential that the eam-cu
configuration states (`eam_tables.build`). Both evaluate the pairs of
`neighbors.half_pairs` that lie within the cutoff, in blocks of pairs.

The contract a model meets (`reference/pair_<style>.py` builds it, and
`md` and `check` use nothing else of it):

- `cutoff`: the force cutoff (length units);
- `evaluate(x, prd, pairs, prec, energy) -> Result`: the forces on the N
  atoms at positions `x` [N, 3] in the periodic box `prd` [3], and with
  `energy` the potential energy, the virial, the summed |virial| and each
  atom's `band`. `pairs` is `neighbors.half_pairs` within cutoff + skin:
  each unordered pair once, some of them beyond the cutoff, which the
  model leaves out itself. A many-body model builds what it needs from
  these pairs, as `EAM` builds each atom's density; a three-body one
  would build each atom's neighbours within the cutoff from them.
  Arithmetic follows `prec` (below).

`Precision` says where each value is computed: positions, velocities and
every sum in `state`, each pair's (and each row's embedding) arithmetic in
`pair`. `REF` is float64 throughout; `CONTROL[dtype]` is the step below a
configuration's type: bfloat16 pair arithmetic over float32 state for
float32, float32 throughout for float64.
"""

from __future__ import annotations

import dataclasses

import torch

from .neighbors import min_image

PAIR_BLOCK = 1 << 22
# Half-width of the band about the cutoff, relative in r^2, in which a
# kernel's r^2 can fall on either side of the cutoff, by the configuration's
# type: float32 positions up to 512 length units have an ulp of 3e-5, and a
# periodic shift by a box length rounds at that scale; float64 the same
# scaled by 2^-29.
CUTOFF_BAND = {"float32": 1e-4, "float64": 1e-12}


@dataclasses.dataclass(frozen=True)
class Precision:
    state: torch.dtype
    pair: torch.dtype


REF = Precision(torch.float64, torch.float64)
# the control of each configuration type: the precision one step below it
CONTROL = {"float32": Precision(torch.float32, torch.bfloat16),
           "float64": Precision(torch.float32, torch.float32)}


@dataclasses.dataclass
class Result:
    f: torch.Tensor          # [N, 3]
    pe: float | None         # total potential energy
    virial: list | None      # [6] sum over pairs of fpair * d_a * d_b
    virial_abs: float | None  # sum over pairs of |fpair| * r^2
    # [N] per atom, the summed |force| of its pairs in the cutoff band,
    # each taken as inside: what a rounded cutoff decision can add or drop
    band: torch.Tensor | None = None


def _blocks(i, j):
    for a in range(0, i.numel(), PAIR_BLOCK):
        yield i[a:a + PAIR_BLOCK], j[a:a + PAIR_BLOCK]


def _pair_geometry(x, prd, bi, bj, prec):
    d = min_image(x[bi] - x[bj], prd.to(x.dtype)).to(prec.pair)
    return d, (d * d).sum(-1)


class _Tally:
    """Energy and virial sums, each pair's terms summed in `state`."""

    def __init__(self, prec, energy: bool):
        self.on = energy
        self.s = prec.state
        self.pe = 0.0
        self.vir = [0.0] * 6
        self.vabs = 0.0

    def add(self, d, r2, fpair, e):
        self.pe += float(e.to(self.s).sum())
        for k, (a, b) in enumerate(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                                    (1, 2))):
            self.vir[k] += float((fpair * d[:, a] * d[:, b]).to(self.s).sum())
        self.vabs += float((fpair * r2).abs().to(self.s).sum())

    def result(self, f, extra_pe=0.0, band=None):
        if not self.on:
            return Result(f, None, None, None)
        return Result(f, self.pe + extra_pe, self.vir, self.vabs, band)


def _band_add(band, bi, bj, r2, fpair_inside, cutsq, width):
    """Add |fpair| r of the pairs in the cutoff band to both atoms."""
    near = (r2 - cutsq).abs() <= width * cutsq
    if bool(near.any()):
        mag = (fpair_inside[near].abs() * torch.sqrt(r2[near])).to(band.dtype)
        band.index_add_(0, bi[near], mag)
        band.index_add_(0, bj[near], mag)


class LJ:
    """lj/cut: E = 4 eps ((s/r)^12 - (s/r)^6) within `cutoff`, no shift."""

    def __init__(self, epsilon: float, sigma: float, cutoff: float,
                 band: float):
        self.cutoff = cutoff
        self.band = band
        self.lj1 = 48.0 * epsilon * sigma ** 12
        self.lj2 = 24.0 * epsilon * sigma ** 6
        self.lj3 = 4.0 * epsilon * sigma ** 12
        self.lj4 = 4.0 * epsilon * sigma ** 6

    def evaluate(self, x, prd, pairs, prec: Precision,
                 energy: bool = False) -> Result:
        i, j = pairs
        f = torch.zeros(x.shape, dtype=prec.state, device=x.device)
        band = torch.zeros(x.shape[0], dtype=prec.state, device=x.device)
        tally = _Tally(prec, energy)
        cutsq = self.cutoff ** 2
        for bi, bj in _blocks(i, j):
            d, r2 = _pair_geometry(x, prd, bi, bj, prec)
            inside = r2 < cutsq
            r2inv = 1.0 / r2
            r6inv = r2inv * r2inv * r2inv
            f_all = r6inv * (self.lj1 * r6inv - self.lj2) * r2inv
            fpair = torch.where(inside, f_all, 0.0)
            fij = (d * fpair[:, None]).to(prec.state)
            f.index_add_(0, bi, fij)
            f.index_add_(0, bj, -fij)
            if energy:
                e = torch.where(inside, r6inv * (self.lj3 * r6inv - self.lj4),
                                0.0)
                tally.add(d, r2, fpair, e)
                _band_add(band, bi, bj, r2, f_all, cutsq, self.band)
        return tally.result(f, band=band)


def clenshaw(c, x, lo: float, hi: float):
    """Chebyshev series sum_k c_k T_k(t), t = (2x - lo - hi) / (hi - lo)."""
    t = (2.0 * x - (lo + hi)) / (hi - lo)
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for ck in c[:0:-1]:
        b1, b2 = 2.0 * t * b1 - b2 + float(ck), b1
    return t * b1 - b2 + float(c[0])


class EAM:
    """Dense EAM in u = r^2 (tables from `eam_tables.build`):
    rho_i = sum_j g(u), fp_i = F'(rho_i) through the fit in s = sqrt(rho),
    F_i = sum_j d_ij * -((fp_i + fp_j) a(u) + b(u)), E = sum_i F(s_i) (+ a
    linear extension above the table) + sum_pairs phi(u). Pair arguments
    are clamped into the fit range, density into its range."""

    def __init__(self, tables: dict, band: float):
        self.t = tables
        self.cutoff = tables["cutoff"]
        self.band = band

    def evaluate(self, x, prd, pairs, prec: Precision,
                 energy: bool = False) -> Result:
        t = self.t
        i, j = pairs
        u_lo, u_hi = t["u_range"]
        rho_lo, rho_hi = t["rho_range"]
        s_lo, s_hi = t["s_range"]
        cutsq = self.cutoff ** 2
        n = x.shape[0]

        def args(bi, bj):
            d, u = _pair_geometry(x, prd, bi, bj, prec)
            inside = u < cutsq
            us = torch.clamp(torch.where(inside, u, u_hi), u_lo, u_hi)
            return d, u, inside, us

        rho = torch.zeros(n, dtype=prec.state, device=x.device)
        for bi, bj in _blocks(i, j):
            _, _, inside, us = args(bi, bj)
            g = torch.where(inside, clenshaw(t["g"], us, u_lo, u_hi),
                            0.0).to(prec.state)
            rho.index_add_(0, bi, g)
            rho.index_add_(0, bj, g)
        rp = rho.to(prec.pair)
        s = torch.sqrt(torch.clamp(rp, rho_lo, rho_hi))
        fp = clenshaw(t["Fp_s"], s, s_lo, s_hi) / (2.0 * s)

        f = torch.zeros(x.shape, dtype=prec.state, device=x.device)
        band = torch.zeros(n, dtype=prec.state, device=x.device)
        tally = _Tally(prec, energy)
        for bi, bj in _blocks(i, j):
            d, u, inside, _ = args(bi, bj)
            us = torch.clamp(u, u_lo, u_hi)
            a = clenshaw(t["a"], us, u_lo, u_hi)
            b = clenshaw(t["b"], us, u_lo, u_hi)
            f_all = -((fp[bi] + fp[bj]) * a + b)
            fpair = torch.where(inside, f_all, 0.0)
            fij = (d * fpair[:, None]).to(prec.state)
            f.index_add_(0, bi, fij)
            f.index_add_(0, bj, -fij)
            if energy:
                e = torch.where(inside, clenshaw(t["phi"], us, u_lo, u_hi),
                                0.0)
                tally.add(d, u, fpair, e)
                _band_add(band, bi, bj, u, f_all, cutsq, self.band)
        embed = 0.0
        if energy:
            e_i = clenshaw(t["F"], s, s_lo, s_hi) + torch.where(
                rp > rho_hi, fp * (rp - rho_hi), 0.0)
            embed = float(e_i.to(prec.state).sum())
        return tally.result(f, embed, band)
