"""Lattice / region / create_atoms: problem setup on the host.

A copy of `lammps_kokkos_port_tpu/core/lattice.py`: the equivalent of the
reference's setup commands (ref: src/lattice.cpp, src/region_block.cpp,
src/create_atoms.cpp). This is pure numpy host code — it runs once before
the step loop, exactly like the reference's input-script phase.

Lattice spacing semantics (ref: src/lattice.cpp:245-265): in `lj` units the
lattice constant is derived from the reduced density,
a = (nbasis / volume / rho*)^(1/dim); in all other units the argument IS the
lattice constant.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_BASES: dict[str, np.ndarray] = {
    "none": np.zeros((1, 3)),
    "sc": np.array([[0.0, 0.0, 0.0]]),
    "bcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    "fcc": np.array([
        [0.0, 0.0, 0.0],
        [0.5, 0.5, 0.0],
        [0.5, 0.0, 0.5],
        [0.0, 0.5, 0.5],
    ]),
    "hcp": np.array([
        [0.0, 0.0, 0.0],
        [0.5, 0.5, 0.0],
        [0.5, 5.0 / 6.0, 0.5],
        [0.0, 1.0 / 3.0, 0.5],
    ]),
    "diamond": np.array([
        [0.0, 0.0, 0.0],
        [0.0, 0.5, 0.5],
        [0.5, 0.0, 0.5],
        [0.5, 0.5, 0.0],
        [0.25, 0.25, 0.25],
        [0.25, 0.75, 0.75],
        [0.75, 0.25, 0.75],
        [0.75, 0.75, 0.25],
    ]),
    # 2d styles
    "sq": np.array([[0.0, 0.0, 0.0]]),
    "sq2": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0]]),
    "hex": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0]]),
}

_2D_STYLES = {"sq", "sq2", "hex"}


@dataclasses.dataclass
class Lattice:
    style: str
    scale: float  # argument: rho* in lj units, lattice constant otherwise
    units_name: str = "lj"
    dimension: int = 3
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    # a1/a2/a3 cell vectors in lattice units (default cubic axes; hex has y=sqrt(3))
    a1: tuple[float, float, float] | None = None
    a2: tuple[float, float, float] | None = None
    a3: tuple[float, float, float] | None = None
    basis: np.ndarray | None = None  # override basis (custom lattice)

    def __post_init__(self):
        if self.style not in _BASES and self.basis is None:
            raise ValueError(f"unknown lattice style {self.style!r}")
        if self.basis is None:
            self.basis = _BASES[self.style]
        if self.a1 is None:
            self.a1 = (1.0, 0.0, 0.0)
        if self.a2 is None:
            y = np.sqrt(3.0) if self.style == "hex" else 1.0
            self.a2 = (0.0, y, 0.0)
        if self.a3 is None:
            z = np.sqrt(8.0 / 3.0) if self.style == "hcp" else 1.0
            self.a3 = (0.0, 0.0, z)
        dim = 2 if self.style in _2D_STYLES else self.dimension
        self.dimension = dim

    @property
    def cell_matrix(self) -> np.ndarray:
        """Columns = a1,a2,a3 in lattice units."""
        return np.stack([self.a1, self.a2, self.a3], axis=1)

    @property
    def spacing(self) -> np.ndarray:
        """Lattice constant per dimension in box units (xlattice etc.)."""
        a = self._lattice_constant()
        # bbox extents of the unit cell (ref: lattice.cpp:271-297); for the
        # default axis-aligned cells this is just the diagonal.
        m = np.abs(self.cell_matrix)
        ext = m.sum(axis=1)
        return ext * a

    def _lattice_constant(self) -> float:
        if self.units_name == "lj":
            nbasis = len(self.basis)
            vol = abs(np.linalg.det(self.cell_matrix))
            return float((nbasis / vol / self.scale) ** (1.0 / self.dimension))
        return float(self.scale)

    def points_in_bounds(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """All lattice points p with lo <= p < hi (box coords), [M,3].

        Points are generated in (basis, i, j, k) lattice-index order with i
        fastest, matching the reference's loop nesting in
        CreateAtoms::add_lattice (k outer, j, i, then basis inner) closely
        enough for deterministic tags.
        """
        a = self._lattice_constant()
        cell = self.cell_matrix * a  # box units
        origin = np.asarray(self.origin) * self.spacing

        # conservative index bounds: transform bbox corners to lattice coords
        corners = np.array([
            [lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
            [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
            [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
            [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]],
        ])
        lcoords = np.linalg.solve(cell, (corners - origin).T).T
        ilo = np.floor(lcoords.min(axis=0)).astype(int) - 1
        ihi = np.ceil(lcoords.max(axis=0)).astype(int) + 1

        ks, js, iis = np.meshgrid(
            np.arange(ilo[2], ihi[2] + 1),
            np.arange(ilo[1], ihi[1] + 1),
            np.arange(ilo[0], ihi[0] + 1),
            indexing="ij",
        )
        idx = np.stack([iis.ravel(), js.ravel(), ks.ravel()], axis=1).astype(np.float64)
        lat = idx[:, None, :] + self.basis[None, :, :]  # [ncells, nbasis, 3]
        identity_cell = (
            np.array_equal(self.a1, (1.0, 0.0, 0.0))
            and np.array_equal(self.a2, (0.0, 1.0, 0.0))
            and np.array_equal(self.a3, (0.0, 0.0, 1.0))
            and np.all(np.asarray(self.origin) == 0.0)
        )
        if identity_cell:
            # Bit-exact reproduction of the reference's lattice2box arithmetic
            # for the default axis-aligned cell: x = (i + basis) * a
            # (ref: src/create_atoms.cpp loop_lattice + src/lattice.cpp
            # lattice2box with identity primitive/rotation). Exactness matters:
            # `velocity ... loop geom` hashes the coordinate BYTES (§A.11).
            pts = lat * a
        else:
            pts = lat @ cell.T + origin
        pts = pts.reshape(-1, 3)

        # boundary rule: include lo (within epsilon), exclude hi
        # (ref: create_atoms.cpp lattice overlap epsilon handling)
        eps = 1e-10 * np.maximum(1.0, np.abs(hi - lo))
        keep = np.all((pts >= lo - eps) & (pts < hi - eps), axis=1)
        return pts[keep]


@dataclasses.dataclass
class RegionBlock:
    """Axis-aligned block region (ref: src/region_block.cpp)."""

    lo: np.ndarray
    hi: np.ndarray

    @staticmethod
    def from_lattice(lattice: Lattice, bounds) -> "RegionBlock":
        """Bounds given in lattice units (the common input-script idiom)."""
        b = np.asarray(bounds, dtype=np.float64).reshape(3, 2)
        sp = lattice.spacing
        return RegionBlock(lo=b[:, 0] * sp, hi=b[:, 1] * sp)

    def contains(self, pts: np.ndarray) -> np.ndarray:
        return np.all((pts >= self.lo) & (pts <= self.hi), axis=1)


def create_atoms(
    lattice: Lattice,
    region_lo,
    region_hi,
    type_id: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Fill [region_lo, region_hi) with lattice points -> (positions, types)."""
    lo = np.asarray(region_lo, dtype=np.float64)
    hi = np.asarray(region_hi, dtype=np.float64)
    pts = lattice.points_in_bounds(lo, hi)
    types = np.full(len(pts), type_id, dtype=np.int32)
    return pts, types
