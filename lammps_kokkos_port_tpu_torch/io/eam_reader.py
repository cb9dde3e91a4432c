"""EAM potential file readers: funcfl (`pair_style eam`), setfl
(`eam/alloy`), and Finnis-Sinclair setfl (`eam/fs`).

Copy of `lammps_kokkos_port_tpu/io/eam_reader.py` (numpy only), plus
`write_sutton_chen_funcfl`, the synthetic stand-in potential the tests and
`chip_smoke.py` run bench/in.eam with while bench/Cu_u3.eam is not in the
repository.

Formats follow the reference (ref: src/MANYBODY/pair_eam.cpp read_file,
pair_eam_alloy.cpp read_file, pair_eam_fs.cpp; bench/Cu_u3.eam):

funcfl:  comment / (Z, mass, a0, lattice) / (nrho drho nr dr cut)
         then nrho F(rho) values, nr Z(r) values, nr rho(r) values.
setfl:   3 comment lines / nelements + names / (nrho drho nr dr cut)
         then per element: (Z mass a0 lattice), nrho F, nelem*nr rho;
         then nelem*(nelem+1)/2 r*phi(r) tables (i>=j order).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Funcfl:
    mass: float
    nrho: int
    drho: float
    nr: int
    dr: float
    cut: float
    frho: np.ndarray  # [nrho] F(rho)
    zr: np.ndarray  # [nr] Z(r) (funcfl) — z2r built as 27.2*0.529*zi*zj
    rhor: np.ndarray  # [nr] rho(r)


@dataclasses.dataclass
class Setfl:
    elements: list[str]
    mass: np.ndarray  # [nelem]
    nrho: int
    drho: float
    nr: int
    dr: float
    cut: float
    frho: np.ndarray  # [nelem, nrho]
    rhor: np.ndarray  # [nelem, nr] (fs: [nelem, nelem, nr])
    z2r: np.ndarray  # [nelem, nelem, nr] r*phi tables (symmetric fill)
    fs: bool = False


def _read_numbers(path: str) -> tuple[list[str], list[float]]:
    with open(path) as f:
        lines = f.read().splitlines()
    return lines


def read_funcfl(path: str) -> Funcfl:
    lines = _read_numbers(path)
    # line 0: comment; line 1: Z mass a0 lattice; line 2: nrho drho nr dr cut
    hdr = lines[1].split()
    mass = float(hdr[1])
    p = lines[2].split()
    nrho, drho, nr, dr, cut = int(p[0]), float(p[1]), int(p[2]), float(p[3]), float(p[4])
    vals = []
    for ln in lines[3:]:
        vals.extend(float(t) for t in ln.split())
    vals = np.asarray(vals, dtype=np.float64)
    need = nrho + 2 * nr
    if len(vals) < need:
        raise ValueError(f"funcfl file {path}: expected {need} values, got {len(vals)}")
    frho = vals[:nrho]
    zr = vals[nrho:nrho + nr]
    rhor = vals[nrho + nr:nrho + 2 * nr]
    return Funcfl(mass=mass, nrho=nrho, drho=drho, nr=nr, dr=dr, cut=cut,
                  frho=frho, zr=zr, rhor=rhor)


def read_setfl(path: str, fs: bool = False) -> Setfl:
    lines = _read_numbers(path)
    elems_line = lines[3].split()
    nelem = int(elems_line[0])
    elements = elems_line[1:1 + nelem]
    p = lines[4].split()
    nrho, drho, nr, dr, cut = int(p[0]), float(p[1]), int(p[2]), float(p[3]), float(p[4])

    vals = []
    elem_masses = []
    # stream the rest token-wise: per element: 4 header values then tables
    tokens = []
    for ln in lines[5:]:
        tokens.extend(ln.split())
    pos = 0

    def take(n):
        nonlocal pos
        out = np.asarray([float(t) for t in tokens[pos:pos + n]], dtype=np.float64)
        if len(out) != n:
            raise ValueError(f"setfl file {path}: ran out of values")
        pos += n
        return out

    frho = np.zeros((nelem, nrho))
    if fs:
        rhor = np.zeros((nelem, nelem, nr))
    else:
        rhor = np.zeros((nelem, nr))
    for i in range(nelem):
        # element header: Z mass a0 lattice — lattice is a STRING (e.g.
        # "FCC"), so parse only the mass (ref: pair_eam_alloy.cpp read_file)
        hdr_toks = tokens[pos:pos + 4]
        pos += 4
        elem_masses.append(float(hdr_toks[1]))
        frho[i] = take(nrho)
        if fs:
            # fs: rho_{alpha beta}(r) for this alpha, all beta
            for jb in range(nelem):
                rhor[i, jb] = take(nr)
        else:
            rhor[i] = take(nr)

    z2r = np.zeros((nelem, nelem, nr))
    for i in range(nelem):
        for j in range(i + 1):
            t = take(nr)
            z2r[i, j] = t
            z2r[j, i] = t

    return Setfl(
        elements=elements, mass=np.asarray(elem_masses), nrho=nrho, drho=drho,
        nr=nr, dr=dr, cut=cut, frho=frho, rhor=rhor, z2r=z2r, fs=fs,
    )


# Sutton & Chen, Phil. Mag. Lett. 61, 139 (1990), Cu: n, m, eps (eV), c, a (A)
SUTTON_CHEN_CU = dict(n=9, m=6, eps=1.2382e-2, c=39.432, a=3.61)


def _fcc_density(rho_fn, a0: float, cut: float) -> float:
    """Host density of one atom of a perfect fcc lattice: sum of rho_fn(r)
    over the neighbours within `cut`."""
    k = int(np.ceil(cut / a0)) + 1
    cells = np.arange(-k, k + 1)
    basis = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(cells, cells, cells, indexing="ij"),
                    axis=-1).reshape(-1, 1, 3)
    r = np.linalg.norm((grid + basis).reshape(-1, 3) * a0, axis=-1)
    r = r[(r > 0) & (r < cut)]
    return float(np.sum(rho_fn(r)))


def write_sutton_chen_funcfl(path, nrho: int = 500, nr: int = 500,
                             dr: float = 0.01, cut: float = 4.95,
                             a0: float = 3.615) -> str:
    """Write the Sutton-Chen Cu potential as a funcfl file shaped like
    bench/Cu_u3.eam (Z 29, mass 63.55, a0 3.615, FCC; nrho = nr = 500,
    dr 0.01, cut 4.95). A synthetic stand-in, not Cu_u3.

    phi(r) = eps (a/r)^n, rho(r) = (a/r)^m, F(rho) = -c eps sqrt(rho); phi
    and rho are shifted to zero value and slope at `cut` (f(r) - f(rc) -
    (r - rc) f'(rc)) and evaluated at max(r, 1 A), so the r = 0 row is
    finite. drho makes the rho table span twice the fcc density at a0.
    Funcfl stores Z(r) with z2r = 27.2*0.529*Z^2 = r*phi. Returns `path`.
    """
    sc = SUTTON_CHEN_CU
    n, m, eps, c, a = sc["n"], sc["m"], sc["eps"], sc["c"], sc["a"]

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
    drho = 2.0 * _fcc_density(rho, a0, cut) / (nrho - 1)
    r = np.arange(nr) * dr
    frho = -c * eps * np.sqrt(np.arange(nrho) * drho)
    zr = np.sqrt(phi(r) * r / (27.2 * 0.529))
    rhor = rho(r)

    lines = ["Sutton-Chen Cu (synthetic stand-in for Cu_u3.eam)",
             f"29 63.55 {a0!r} FCC",
             f"{nrho} {drho!r} {nr} {dr!r} {cut!r}"]
    vals = np.concatenate([frho, zr, rhor])
    for i in range(0, len(vals), 5):
        lines.append(" ".join(f"{v:.16e}" for v in vals[i:i + 5]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)
