"""The reference of `pair_style tersoff` (one element), in plain PyTorch.

    E       = 1/2 sum_i sum_{j != i} fc(r_ij) [A e^{-lam1 r_ij}
                                              - b_ij B e^{-lam2 r_ij}]
    b_ij    = (1 + (beta zeta_ij)^n)^{-1/(2n)}
    zeta_ij = sum_{k != i, j} fc(r_ik) g(cos theta_ijk)
                              exp[(lam3 (r_ij - r_ik))^m]
    g(c)    = gamma (1 + c0^2/d^2 - c0^2 / (d^2 + (c - h)^2))
    fc(r)   = 1 below R - D, 1/2 (1 - sin(pi/2 (r - R)/D)) up to R + D, 0
              beyond

(J. Tersoff, Phys. Rev. B 37, 6991 (1988); LAMMPS
src/MANYBODY/pair_tersoff.cpp). Each atom's neighbours within R + D are
built from the half pairs (both directions of each pair); the energy is a
function of the displacements d = x_j - x_i of these directed pairs, and
the forces are -dE/dx by torch.autograd over the displacements: f_i += g,
f_j -= g with g = dE/dd. The virial is -sum d (x) g (xx, yy, zz, xy, xz,
yz), the pressure scale's `virial_abs` sum |d . g|. The triplets (i; j, k)
are formed per block of centre atoms, at most TRIPLET_BLOCK a block, and
a block's energy depends only on its own displacements, so each block is
differentiated on its own. Arithmetic follows `prec` (models.py): the
displacements and every term in `prec.pair`, the forces and sums in
`prec.state`. No matrix product is used, so no TF32 setting matters.

`band` is all zeros: fc and fc' are both 0 at R + D, so a pair that a
rounded cutoff decision takes in or leaves out adds no force.

Departures from LAMMPS's ters_* functions, none of which moves a result by
more than rounding at this potential's states:

- b_ij is (1 + (beta zeta)^n)^{-1/(2n)} for every beta zeta, computed as
  exp(-softplus(n log(beta zeta)) / (2n)) (zeta held above the smallest
  normal number), where ters_bij switches to asymptotic forms beyond its
  thresholds c1-c4 (which differ from the full form by less than 1e-16
  relative);
- the exponent (lam3 (r_ij - r_ik))^m is clamped to +-69.0776, where
  LAMMPS sets the exponential to 1e30 above and 0 below;
- forces by autograd on the energy, not the analytic chain rule;
- one element only: the file must hold one entry, of one element.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench_port.reference.models import Result
from bench_port.reference.neighbors import min_image

# the numbers of an entry after its three element names (LAMMPS's order)
FIELDS = ("m", "gamma", "lam3", "c", "d", "h", "n", "beta", "lam2", "bigb",
          "bigr", "bigd", "lam1", "biga")
TRIPLET_BLOCK = 1 << 22
EX_CLIP = 69.0776


def read(path: str) -> dict:
    """The one entry of a single-element .tersoff file: {field: value}."""
    words = []
    with open(path) as f:
        for line in f:
            words.extend(line.split("#")[0].split())
    width = 3 + len(FIELDS)
    if len(words) != width or len(set(words[:3])) != 1:
        raise NotImplementedError(
            f"{path}: the reference takes one entry of one element, found "
            f"{len(words) / width:g} entries")
    return dict(zip(FIELDS, map(float, words[3:])))


class Tersoff:
    """One element's Tersoff potential (`read`'s parameters)."""

    def __init__(self, p: dict):
        if p["m"] not in (1.0, 3.0):
            raise ValueError(f"tersoff m must be 1 or 3, got {p['m']}")
        self.p = p
        self.cutoff = p["bigr"] + p["bigd"]

    def _fc(self, r):
        p = self.p
        ramp = 0.5 * (1.0 - torch.sin(0.5 * math.pi * (r - p["bigr"])
                                      / p["bigd"]))
        return torch.where(r < p["bigr"] - p["bigd"], 1.0,
                           torch.where(r > self.cutoff, 0.0, ramp))

    def _pair_energy(self, d, tp, tq):
        """Each directed pair's energy 1/2 fc [A e^{-lam1 r} - b B
        e^{-lam2 r}], from the displacements `d` [P, 3] and the triplets
        (tp, tq): pair tp's zeta takes pair tq as its k."""
        p = self.p
        r = torch.sqrt((d * d).sum(-1))
        fc = self._fc(r)
        rp, rq = r[tp], r[tq]
        cos = (d[tp] * d[tq]).sum(-1) / (rp * rq)
        c2, d2 = p["c"] ** 2, p["d"] ** 2
        g = p["gamma"] * (1.0 + c2 / d2 - c2 / (d2 + (cos - p["h"]) ** 2))
        arg = p["lam3"] * (rp - rq)
        if p["m"] == 3.0:
            arg = arg ** 3
        term = fc[tq] * g * torch.exp(arg.clamp(-EX_CLIP, EX_CLIP))
        zeta = torch.zeros_like(r).index_add(0, tp, term)
        tiny = torch.finfo(d.dtype).tiny
        logbz = torch.log(p["beta"] * zeta.clamp(min=tiny))
        b = torch.exp(-F.softplus(p["n"] * logbz) / (2.0 * p["n"]))
        return 0.5 * fc * (p["biga"] * torch.exp(-p["lam1"] * r)
                           - b * p["bigb"] * torch.exp(-p["lam2"] * r))

    def evaluate(self, x, prd, pairs, prec, energy: bool = False) -> Result:
        i, j = pairs
        n = x.shape[0]
        dev = x.device
        xs = x.to(prec.state)
        d = min_image(xs[j] - xs[i], prd.to(prec.state)).to(prec.pair)
        inside = (d * d).sum(-1) < self.cutoff ** 2
        i, j, d = i[inside], j[inside], d[inside]
        # the directed pairs, grouped by their centre atom
        ci = torch.cat([i, j])
        order = torch.argsort(ci, stable=True)
        ci = ci[order]
        cj = torch.cat([j, i])[order]
        dd = torch.cat([d, -d])[order]
        deg = torch.bincount(ci, minlength=n)
        start = torch.cumsum(deg, 0) - deg

        f = torch.zeros((n, 3), dtype=prec.state, device=dev)
        pe, vir, vabs = 0.0, [0.0] * 6, 0.0
        per_atom = max(1, TRIPLET_BLOCK // max(1, int(deg.max()) ** 2))
        for a0 in range(0, n, per_atom):
            a1 = min(n, a0 + per_atom)
            p0 = int(start[a0])
            p1 = int(start[a1]) if a1 < n else ci.numel()
            if p1 == p0:
                continue
            centre = ci[p0:p1]
            rep = deg[centre]
            tp = torch.repeat_interleave(
                torch.arange(p1 - p0, device=dev), rep)
            first = torch.cumsum(rep, 0) - rep
            tq = (start[centre][tp] - p0
                  + torch.arange(tp.numel(), device=dev) - first[tp])
            keep = tq != tp
            tp, tq = tp[keep], tq[keep]
            leaf = dd[p0:p1].clone().requires_grad_(True)
            e = self._pair_energy(leaf, tp, tq)
            (grad,) = torch.autograd.grad(e.sum(), leaf)
            gs = grad.to(prec.state)
            f.index_add_(0, centre, gs)
            f.index_add_(0, cj[p0:p1], -gs)
            if energy:
                leaf = leaf.detach()
                pe += float(e.detach().to(prec.state).sum())
                for k, (u, w) in enumerate(((0, 0), (1, 1), (2, 2), (0, 1),
                                            (0, 2), (1, 2))):
                    vir[k] -= float((leaf[:, u] * grad[:, w]).to(
                        prec.state).sum())
                vabs += float((leaf * grad).sum(-1).abs().to(
                    prec.state).sum())
        if not energy:
            return Result(f, None, None, None)
        band = torch.zeros(n, dtype=prec.state, device=dev)
        return Result(f, pe, vir, vabs, band)


def build(config: dict, potential_path, band: float):
    """(model, mass): the potential file of the run, read here, and the
    configuration's `mass` (the deck's `mass 1`)."""
    if potential_path is None:
        raise FileNotFoundError(
            "reference/pair_tersoff.py reads the run's potential file, and "
            "none was given")
    return Tersoff(read(potential_path)), float(config["mass"])
