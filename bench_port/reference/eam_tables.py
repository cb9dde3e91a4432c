"""The dense EAM mathematics that the eam-cu configuration states, built
from a funcfl file with numpy in float64.

From the file (LAMMPS `pair_style eam`, one element): the F(rho), Z(r) and
rho(r) tables are put on the common grid (PairEAM::file2array's 4-point
Lagrange resampling), z2r = 27.2 * 0.529 * Z(r)^2, and each table gets
LAMMPS's 7-coefficient cubic spline (PairEAM::interpolate). The
configuration's `math` block then fixes the fits the dense path runs:
Chebyshev series in u = r^2 over [r_lo_frac * rc, rc] of rho(r) (`g`) and
of z2r(r)/r (`phi`), of degree `deg`, fitted to `pair_samples` equally
spaced r; their derivative series `a` = 2 g'(u) and `b` = 2 phi'(u); and
F fitted in s = sqrt(rho) over [s_lo_frac * s_hi, s_hi] (s_hi = sqrt of
the table's rho range) with degree `deg_embed` to `embed_samples` points,
with `Fp_s` = dF/ds. Densities clamp into [s_lo^2, rho_max].
"""

from __future__ import annotations

import numpy as np


def read_funcfl(path: str) -> dict:
    """The header and the three tables of a funcfl file."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    mass = float(lines[1].split()[1])
    w = lines[2].split()
    nrho, drho, nr, dr, cut = int(w[0]), float(w[1]), int(w[2]), float(
        w[3]), float(w[4])
    vals = np.array([float(v) for ln in lines[3:] for v in ln.split()])
    if vals.size < nrho + 2 * nr:
        raise ValueError(f"{path}: {vals.size} values, {nrho + 2 * nr} "
                         "expected")
    return dict(mass=mass, nrho=nrho, drho=drho, nr=nr, dr=dr, cut=cut,
                frho=vals[:nrho], zr=vals[nrho:nrho + nr],
                rhor=vals[nrho + nr:nrho + 2 * nr])


def resample(src, src_delta: float, n_out: int, out_delta: float):
    """file2array's Lagrange resampling onto r = (m - 1) * out_delta."""
    n = len(src)
    s = np.concatenate([[0.0], src])
    r = np.arange(n_out) * out_delta
    p = r / src_delta + 1.0
    k = np.clip(np.floor(p).astype(int), 2, n - 2)
    p = np.minimum(p - k, 2.0)
    return (-p * (p - 1.0) * (p - 2.0) / 6.0 * s[k - 1]
            + 0.5 * (p * p - 1.0) * (p - 2.0) * s[k]
            - 0.5 * p * (p + 1.0) * (p - 2.0) * s[k + 1]
            + p * (p * p - 1.0) / 6.0 * s[k + 2])


def spline(f, delta: float):
    """PairEAM::interpolate: rows 1..n of [n + 1, 7] coefficients."""
    n = len(f)
    c = np.zeros((n + 1, 7))
    c[1:, 6] = f
    c[1, 5] = c[2, 6] - c[1, 6]
    c[2, 5] = 0.5 * (c[3, 6] - c[1, 6])
    c[n - 1, 5] = 0.5 * (c[n, 6] - c[n - 2, 6])
    c[n, 5] = c[n, 6] - c[n - 1, 6]
    m = np.arange(3, n - 1)
    c[m, 5] = ((c[m - 2, 6] - c[m + 2, 6])
               + 8.0 * (c[m + 1, 6] - c[m - 1, 6])) / 12.0
    m = np.arange(1, n)
    c[m, 4] = 3.0 * (c[m + 1, 6] - c[m, 6]) - 2.0 * c[m, 5] - c[m + 1, 5]
    c[m, 3] = c[m, 5] + c[m + 1, 5] - 2.0 * (c[m + 1, 6] - c[m, 6])
    c[1:, 2] = c[1:, 5] / delta
    c[1:, 1] = 2.0 * c[1:, 4] / delta
    c[1:, 0] = 3.0 * c[1:, 3] / delta
    return c


def spline_value(c, delta: float, x):
    """Value and derivative of a `spline` table at x (LAMMPS's lookup)."""
    n = c.shape[0] - 1
    p = x / delta + 1.0
    m = np.clip(np.floor(p).astype(int), 1, n - 1)
    p = np.clip(p - m, 0.0, 1.0)
    k = c[m]
    val = ((k[:, 3] * p + k[:, 4]) * p + k[:, 5]) * p + k[:, 6]
    der = (k[:, 0] * p + k[:, 1]) * p + k[:, 2]
    return val, der


def build(path: str, math: dict) -> dict:
    """The fits of the configuration's `math` block from the funcfl file."""
    ff = read_funcfl(path)
    dr, drho = ff["dr"], ff["drho"]
    nr = int((ff["nr"] - 1) * dr / dr + 0.5)
    nrho = int((ff["nrho"] - 1) * drho / drho + 0.5)
    rhomax = (ff["nrho"] - 1) * drho
    rho_c = spline(resample(ff["rhor"], dr, nr, dr), dr)
    z2r_c = spline(27.2 * 0.529 * resample(ff["zr"], dr, nr, dr) ** 2, dr)
    frho_c = spline(resample(ff["frho"], drho, nrho, drho), drho)

    rc = ff["cut"]
    r_lo = math["r_lo_frac"] * rc
    u_lo, u_hi = r_lo * r_lo, rc * rc
    r = np.linspace(r_lo, rc, math["pair_samples"])
    u = r * r
    cheb = np.polynomial.chebyshev

    def fit(y, x, lo, hi, deg):
        return cheb.chebfit((2.0 * x - (lo + hi)) / (hi - lo), y, deg)

    def der(c, lo, hi):
        return cheb.chebder(c) * (2.0 / (hi - lo))

    g = fit(spline_value(rho_c, dr, r)[0], u, u_lo, u_hi, math["deg"])
    phi = fit(spline_value(z2r_c, dr, r)[0] / r, u, u_lo, u_hi, math["deg"])
    s_hi = np.sqrt(rhomax)
    s_lo = math["s_lo_frac"] * s_hi
    sg = np.linspace(s_lo, s_hi, math["embed_samples"])
    big_f = fit(spline_value(frho_c, drho, sg * sg)[0], sg, s_lo, s_hi,
                math["deg_embed"])
    return {
        "g": g, "phi": phi,
        "a": 2.0 * der(g, u_lo, u_hi), "b": 2.0 * der(phi, u_lo, u_hi),
        "F": big_f, "Fp_s": der(big_f, s_lo, s_hi),
        "u_range": (u_lo, u_hi), "s_range": (s_lo, s_hi),
        "rho_range": (s_lo * s_lo, rhomax), "cutoff": rc, "mass": ff["mass"],
    }
