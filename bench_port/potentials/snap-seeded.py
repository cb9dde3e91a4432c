"""The writer of the potential kind `snap-seeded`: LAMMPS's
W_2940_2017_2.pot.snap (pair_style hybrid/overlay zbl 4.0 4.8 snap) with
the published hyperparameters and ZBL terms, and the linear SNAP
coefficients drawn from a seed.

The published W_2940_2017_2.snapcoeff is not in the repository. The cost
of a step does not depend on the coefficients' values, only on twojmax and
the neighbour counts, so beta_0 = 0 and beta_k = s N(0, 1), k = 1..55, from
numpy's default generator on the configuration's own `coeff_seed` (not the
run's seed), s = `beta_scale`. The include file the deck reads is written
under the deck's token, with absolute paths to the .snapcoeff and
.snapparam written beside it. Every number comes from the configuration's
`potential` block.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def ncoeff(twojmax: int) -> int:
    """Bispectrum components (j1, j2, j), j2 <= j1 <= j, of a twojmax."""
    return sum(1 for j1 in range(twojmax + 1) for j2 in range(j1 + 1)
               for j in range(j1 - j2, min(twojmax, j1 + j2) + 1, 2)
               if j >= j1)


def coefficients(spec: dict) -> np.ndarray:
    """beta_0 = 0, then the seeded beta_1..beta_n."""
    rng = np.random.default_rng(spec["coeff_seed"])
    beta = spec["beta_scale"] * rng.standard_normal(ncoeff(spec["twojmax"]))
    return np.concatenate([[0.0], beta])


def write(path, spec: dict) -> str:
    """Write the include file `path` and its .snapcoeff and .snapparam
    beside it; returns the include file's path."""
    path = Path(path).resolve()
    stem = spec["stem"]
    coeff = path.parent / f"{stem}.snapcoeff"
    param = path.parent / f"{stem}.snapparam"
    beta = coefficients(spec)
    el = spec["element"]
    lines = [f"# {stem}.snapcoeff with seeded coefficients (coeff_seed "
             f"{spec['coeff_seed']}, scale {spec['beta_scale']!r})",
             f"1 {beta.size}", f"{el} {spec['radelem']!r} {spec['wj']!r}"]
    lines += [f"{b:.17e}" for b in beta]
    coeff.write_text("\n".join(lines) + "\n")
    param.write_text("\n".join(
        [f"rcutfac {spec['rcutfac']!r}", f"twojmax {spec['twojmax']}",
         f"rfac0 {spec['rfac0']!r}", f"rmin0 {spec['rmin0']!r}",
         f"bzeroflag {spec['bzeroflag']}",
         f"quadraticflag {spec['quadraticflag']}"]) + "\n")
    z = spec["zbl"]
    path.write_text("\n".join([
        "# Definition of SNAP+ZBL potential.",
        f"variable zblcutinner equal {z['inner']!r}",
        f"variable zblcutouter equal {z['outer']!r}",
        f"variable zblz equal {z['z']!r}",
        "",
        "# Specify hybrid with SNAP and ZBL",
        "",
        "pair_style hybrid/overlay &",
        "zbl ${zblcutinner} ${zblcutouter} &",
        "snap",
        "pair_coeff 1 1 zbl ${zblz} ${zblz}",
        f"pair_coeff * * snap {coeff} {param} {el}"]) + "\n")
    return str(path)
