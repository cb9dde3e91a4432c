"""Pair style tersoff (one element): the Tersoff bond-order potential.

Port of `lammps_kokkos_port_tpu/models/pair_tersoff.py` for one element
(ref: src/MANYBODY/pair_tersoff.cpp read_file, field order :56-74, and the
ters_* functions). The JAX package takes the forces as jax.grad of one
closed-form energy over its neighbour matrix; the port computes them as
LAMMPS and Kokkos do, by the analytic chain rule, in the CUDA kernels of
ops/tersoff_kernels (a short list of each atom's neighbours within R + D,
then one three-body pass), with no autograd on the step path:

    E      = 1/2 sum_i sum_{j != i} fc(r_ij) [A e^{-lam1 r_ij}
                                             - b_ij B e^{-lam2 r_ij}]
    b_ij   = (1 + (beta zeta_ij)^n)^{-1/(2n)}   (ters_bij's branches)
    zeta_ij = sum_{k != i, j} fc(r_ik) g(cos theta_ijk)
                              exp[(lam3 (r_ij - r_ik))^m]
    g      = gamma (1 + c^2/d^2 - c^2 / (d^2 + (cos theta - h)^2))

The style is a parameter record: host floats read from the file, passed
to the kernels by value and rounded to the run's type there. It runs in
list mode "sorted" alone, which "auto" resolves to (`force_paths`).
Multi-element tables and the `shift` keyword raise NotImplementedError,
as do tersoff/mod and tersoff/zbl (script.py).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

from ..ops import tersoff_kernels
from .pair import ForcePaths

# the numbers of one entry in the file's order (after the three elements)
FIELDS = ("m", "gamma", "lam3", "c", "d", "h", "n", "beta", "lam2", "bigb",
          "bigr", "bigd", "lam1", "biga")


def read_tersoff_file(path: str) -> dict:
    """{(el_i, el_j, el_k): {field: value}} of a .tersoff file: entries of
    three element names and the 14 numbers of FIELDS, in any line layout,
    '#' starting a comment (ref: PairTersoff::read_file)."""
    tokens = []
    with open(path) as f:
        for line in f:
            tokens.extend(line.split("#")[0].split())
    width = 3 + len(FIELDS)
    if len(tokens) % width:
        raise ValueError(f"{path}: {len(tokens)} words are not whole "
                         f"entries of {width}")
    entries = {}
    for pos in range(0, len(tokens), width):
        key = tuple(tokens[pos:pos + 3])
        entries[key] = dict(zip(FIELDS, map(float,
                                            tokens[pos + 3:pos + width])))
    return entries


@dataclasses.dataclass(frozen=True)
class PairTersoff:
    """One element's Tersoff parameters (LAMMPS's names: bigb = B, bigr =
    R, bigd = D, biga = A)."""

    element: str
    m: float
    gamma: float
    lam3: float
    c: float
    d: float
    h: float
    n: float
    beta: float
    lam2: float
    bigb: float
    bigr: float
    bigd: float
    lam1: float
    biga: float

    force_paths: ClassVar[ForcePaths] = ForcePaths(
        {"sorted": tersoff_kernels.compute})

    def max_cutoff(self) -> float:
        """R + D: fc and its derivative are 0 beyond it."""
        return self.bigr + self.bigd

    def kernel_params(self) -> tuple:
        """The numbers the kernels and their twins take, in FIELDS order."""
        return tuple(getattr(self, f) for f in FIELDS)


def make_tersoff(ntypes: int, path: str, elements: list[str]) -> PairTersoff:
    """pair_style tersoff; pair_coeff * * <file> <El> for one atom type."""
    if ntypes != 1 or len(elements) != 1:
        raise NotImplementedError(
            f"tersoff with {ntypes} atom types ({' '.join(elements)}): only "
            "a single element is ported (multi-element tables are not)")
    el = elements[0]
    entries = read_tersoff_file(path)
    key = (el, el, el)
    if key not in entries:
        raise ValueError(f"{path}: no entry {' '.join(key)}")
    vals = entries[key]
    if vals["m"] not in (1.0, 3.0):
        raise ValueError(f"tersoff m must be 1 or 3, got {vals['m']}")
    return PairTersoff(element=el, **vals)
