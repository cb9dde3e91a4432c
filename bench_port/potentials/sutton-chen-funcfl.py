"""The writer of the potential kind `sutton-chen-funcfl`: the Sutton-Chen Cu
funcfl stand-in for bench/Cu_u3.eam.

Sutton & Chen, Phil. Mag. Lett. 61, 139 (1990): phi(r) = eps (a/r)^n,
rho(r) = (a/r)^m, F(rho) = -c eps sqrt(rho). phi and rho are shifted to
zero value and slope at the cutoff (f(r) - f(rc) - (r - rc) f'(rc)) and
taken at max(r, 1 A), so the r = 0 row is finite; drho makes the rho table
span twice the fcc density at a0. Funcfl stores Z(r) with z2r = 27.2 *
0.529 * Z^2 = r phi. Every number comes from the configuration's
`potential` block.
"""

from __future__ import annotations

import numpy as np


def fcc_density(rho_fn, a0: float, cut: float) -> float:
    """Density at one atom of a perfect fcc lattice of constant a0."""
    k = int(np.ceil(cut / a0)) + 1
    cells = np.arange(-k, k + 1)
    basis = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(cells, cells, cells, indexing="ij"),
                    axis=-1).reshape(-1, 1, 3)
    r = np.linalg.norm((grid + basis).reshape(-1, 3) * a0, axis=-1)
    r = r[(r > 0) & (r < cut)]
    return float(np.sum(rho_fn(r)))


def write(path, spec: dict) -> str:
    """Write the funcfl file of `spec` (the configuration's `potential`)
    to `path`; returns the path."""
    n, m, eps, c, a = (spec[k] for k in ("n", "m", "eps", "c", "a"))
    nrho, nr, dr, cut, a0 = (spec[k] for k in ("nrho", "nr", "dr", "cut",
                                               "a0"))

    def shifted(p, scale):
        def f(r):
            return scale * (a / r) ** p

        def fprime(r):
            return -p * scale * (a / r) ** p / r

        def g(r):
            r = np.maximum(np.asarray(r, dtype=np.float64), 1.0)
            return np.where(r < cut,
                            f(r) - f(cut) - (r - cut) * fprime(cut), 0.0)
        return g

    phi = shifted(n, eps)
    rho = shifted(m, 1.0)
    drho = 2.0 * fcc_density(rho, a0, cut) / (nrho - 1)
    r = np.arange(nr) * dr
    frho = -c * eps * np.sqrt(np.arange(nrho) * drho)
    zr = np.sqrt(phi(r) * r / (27.2 * 0.529))
    lines = ["Sutton-Chen Cu (synthetic stand-in for Cu_u3.eam)",
             f"29 {spec['mass']!r} {a0!r} FCC",
             f"{nrho} {drho!r} {nr} {dr!r} {cut!r}"]
    vals = np.concatenate([frho, zr, rho(r)])
    for i in range(0, len(vals), 5):
        lines.append(" ".join(f"{v:.16e}" for v in vals[i:i + 5]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)
