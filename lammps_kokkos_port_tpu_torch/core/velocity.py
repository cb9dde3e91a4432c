"""Velocity initialization: `velocity <group> create T seed [loop geom|all] ...`.

A copy of `lammps_kokkos_port_tpu/core/velocity.py`, so both packages draw
the same bits. Bit-exact re-implementation of the reference's deterministic
velocity setup
(ref: src/velocity.cpp:161-420, src/random_park.cpp). This is host-side numpy
setup code (runs once), vectorized over atoms.

`loop geom` seeds a Park-Miller RNG per atom from a Jenkins one-at-a-time hash
of (user seed bytes, coordinate bytes), making the result independent of the
domain decomposition (ref: src/random_park.cpp RanPark::reset(int, double*)).
We reproduce it bit-for-bit — including the signed-char byte accumulation and
the 27-bit seed mask — so step-0 thermo output matches the reference's golden
logs exactly (SURVEY.md §A.16).
"""

from __future__ import annotations

import numpy as np

from ..utils.units import Units

_IA = 16807
_IM = 2147483647
_AM = 1.0 / _IM
_MASK32 = np.uint64(0xFFFFFFFF)


def _jenkins_hash_seeds(seed: int, coords: np.ndarray) -> np.ndarray:
    """Per-atom Park-Miller seeds from the Jenkins one-at-a-time hash of
    (seed bytes ++ coordinate bytes), vectorized over atoms.

    Matches RanPark::reset(int ibase, double *coord): bytes are accumulated as
    *signed* chars; the final seed keeps only 27 bits (`hash & 0x7ffffff` —
    the reference masks 27 bits despite its comment saying 31) and 0 maps to 1.
    """
    coords = np.ascontiguousarray(coords, dtype="<f8")
    n = coords.shape[0]
    coord_bytes = coords.view(np.int8).reshape(n, 24)
    seed_bytes = np.array([seed], dtype="<i4").view(np.int8)

    h = np.zeros(n, dtype=np.uint64)

    def mix(h, b):
        # b: int64 array or scalar already wrapped to uint32 range
        h = (h + b) & _MASK32
        h = (h + ((h << np.uint64(10)) & _MASK32)) & _MASK32
        h = h ^ (h >> np.uint64(6))
        return h

    for sb in seed_bytes:
        b = np.uint64(np.int64(sb) & 0xFFFFFFFF)
        h = mix(h, b)
    for i in range(24):
        b = (coord_bytes[:, i].astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
        h = mix(h, b)

    h = (h + ((h << np.uint64(3)) & _MASK32)) & _MASK32
    h = h ^ (h >> np.uint64(11))
    h = (h + ((h << np.uint64(15)) & _MASK32)) & _MASK32

    s = (h & np.uint64(0x7FFFFFF)).astype(np.int64)
    s[s == 0] = 1
    return s


def _park_miller_uniform(seeds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One Park-Miller step per lane: returns (uniform in (0,1), new seeds)."""
    seeds = (_IA * seeds) % _IM
    return _AM * seeds.astype(np.float64), seeds


def create_velocities_geom(
    coords: np.ndarray,
    masses_per_atom: np.ndarray,
    t_desired: float,
    seed: int,
    units: Units,
    dist: str = "uniform",
    dimension: int = 3,
    zero_linear_momentum: bool = True,
    rescale_to_t: bool = True,
) -> np.ndarray:
    """`velocity all create T seed loop geom [dist uniform|gaussian]`.

    Per atom: hash coords -> seed, warm up 5 uniforms, draw vx,vy,vz,
    scale by 1/sqrt(mass); then zero the group's linear momentum and rescale
    to the target temperature (ref: src/velocity.cpp:329-370, zero_momentum,
    rescale).
    """
    n = coords.shape[0]
    seeds = _jenkins_hash_seeds(seed, coords)
    for _ in range(5):  # warm-up, ref: random_park.cpp reset()
        _, seeds = _park_miller_uniform(seeds)

    if dist == "uniform":
        u = np.empty((n, 3))
        for d in range(3):
            u[:, d], seeds = _park_miller_uniform(seeds)
        raw = u - 0.5
    elif dist == "gaussian":
        raw = _gaussian_draws(seeds)
    else:
        raise ValueError(f"unknown velocity dist {dist!r}")

    factor = 1.0 / np.sqrt(masses_per_atom)
    v = raw * factor[:, None]
    if dimension == 2:
        v[:, 2] = 0.0

    if zero_linear_momentum:
        mtot = masses_per_atom.sum()
        vcm = (masses_per_atom[:, None] * v).sum(axis=0) / mtot
        v -= vcm

    if rescale_to_t:
        v = rescale(v, masses_per_atom, t_desired, units, dimension)
    return v


def _gaussian_draws(seeds: np.ndarray) -> np.ndarray:
    """Marsaglia polar gaussian pairs matching RanPark::gaussian lane-wise."""
    seeds = seeds.copy()
    n = seeds.shape[0]
    out = np.empty((n, 3))
    second = np.zeros(n)
    have_saved = np.zeros(n, dtype=bool)
    for d in range(3):
        vals = np.empty(n)
        consumed = have_saved.copy()
        vals[consumed] = second[consumed]
        # rejection loop for lanes that need a fresh pair
        pending = np.flatnonzero(~consumed)
        while pending.size:
            u1, seeds[pending] = _park_miller_uniform(seeds[pending])
            u2, seeds[pending] = _park_miller_uniform(seeds[pending])
            v1 = 2.0 * u1 - 1.0
            v2 = 2.0 * u2 - 1.0
            rsq = v1 * v1 + v2 * v2
            ok = (rsq < 1.0) & (rsq != 0.0)
            idx = pending[ok]
            fac = np.sqrt(-2.0 * np.log(rsq[ok]) / rsq[ok])
            vals[idx] = v2[ok] * fac  # "first"
            second[idx] = v1[ok] * fac
            pending = pending[~ok]
        # lanes that consumed their stash are empty now; generators hold one
        have_saved = ~consumed
        out[:, d] = vals
    return out


def create_velocities_loop_all(
    natoms: int,
    masses_per_atom: np.ndarray,
    t_desired: float,
    seed: int,
    units: Units,
    dist: str = "uniform",
    dimension: int = 3,
) -> np.ndarray:
    """`velocity all create T seed` (loop all, the default): one sequential
    Park-Miller stream over atom IDs 1..N (ref: src/velocity.cpp:245-300) —
    identical velocities regardless of decomposition when IDs are 1..N.
    """
    s = seed
    vals = np.empty(3 * natoms)
    if dist != "uniform":
        raise NotImplementedError("loop all gaussian: use loop geom")
    for i in range(3 * natoms):
        s = (_IA * s) % _IM
        vals[i] = _AM * s
    raw = vals.reshape(natoms, 3) - 0.5
    factor = 1.0 / np.sqrt(masses_per_atom)
    v = raw * factor[:, None]
    if dimension == 2:
        v[:, 2] = 0.0
    mtot = masses_per_atom.sum()
    vcm = (masses_per_atom[:, None] * v).sum(axis=0) / mtot
    v -= vcm
    return rescale(v, masses_per_atom, t_desired, units, dimension)


def temperature(
    v: np.ndarray, masses_per_atom: np.ndarray, units: Units, dimension: int = 3,
    extra_dof: int | None = None,
) -> float:
    """compute temp: T = sum(m v^2) * mvv2e / (dof * kB), dof = dim*N - dim
    (ref: src/compute_temp.cpp:58-100, src/compute.cpp:84 extra_dof default)."""
    n = v.shape[0]
    if extra_dof is None:
        extra_dof = dimension
    dof = dimension * n - extra_dof
    if dof <= 0:
        return 0.0
    ke2 = (masses_per_atom[:, None] * v * v).sum()
    return float(ke2 * units.mvv2e / (dof * units.boltz))


def rescale(
    v: np.ndarray, masses_per_atom: np.ndarray, t_new: float, units: Units,
    dimension: int = 3,
) -> np.ndarray:
    t_old = temperature(v, masses_per_atom, units, dimension)
    if t_old == 0.0:
        raise ValueError("cannot rescale velocities: current temperature is 0")
    return v * np.sqrt(t_new / t_old)
