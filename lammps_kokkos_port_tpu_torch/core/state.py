"""Per-atom state: the equivalent of Atom/AtomVec (ref: src/atom.h:70-170).

Port of `lammps_kokkos_port_tpu/core/state.py`. The state is one frozen
dataclass of fixed-shape padded tensors on one device:

  - capacity (`cap`) is a padded size >= number of atoms;
  - padding rows have type 0, tag 0, mask 0;
  - optional fields (charge, molecule) are None when the atom style does
    not carry them.

Host bookkeeping that the JAX package kept on the device (`nlocal`,
`ntimestep`) is a plain Python int here: the host always knows it, and
reading a device scalar would synchronise the host with the GPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .box import Box


@dataclasses.dataclass(frozen=True)
class State:
    """Simulation state (atoms + box). Types are 1-based; padding has type
    0. Per-type mass lives in `mass` [ntypes+1] (slot 0 set to 1 so padding
    never divides by zero)."""

    x: torch.Tensor  # [cap, 3] positions
    v: torch.Tensor  # [cap, 3] velocities
    f: torch.Tensor  # [cap, 3] forces
    type: torch.Tensor  # [cap] int32, 1-based; 0 = padding
    tag: torch.Tensor  # [cap] int32 atom IDs, 1-based; 0 = padding
    image: torch.Tensor  # [cap, 3] int32 periodic image counts
    q: torch.Tensor | None  # [cap] charge, or None
    molecule: torch.Tensor | None  # [cap] int32 molecule IDs, or None
    box: Box
    mass: torch.Tensor  # [ntypes+1] per-type mass
    nlocal: int  # number of real atoms
    # group membership bitmask, bit 0 = group "all" (ref: src/group.h:28)
    mask: torch.Tensor  # [cap] int32
    virial: torch.Tensor  # [6] Voigt virial of the last tallied pass
    ntimestep: int
    aux: dict
    units_name: str = "lj"
    dimension: int = 3
    # True when every valid row is an owned atom at an arbitrary row index
    # (the cell-major sorted layout, ops/sortedforce)
    owned_all: bool = False

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def valid_mask(self) -> torch.Tensor:
        """[cap] bool: True for existing atoms (group bit set)."""
        return self.mask != 0

    @property
    def owned_mask(self) -> torch.Tensor:
        """[cap] bool: atoms this process owns (all valid rows in the
        sorted layout, rows [0, nlocal) otherwise)."""
        if self.owned_all:
            return self.valid_mask
        rows = torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device)
        return (rows < self.nlocal) & self.valid_mask

    @property
    def per_atom_mass(self) -> torch.Tensor:
        """[cap] mass of each atom via its type."""
        return self.mass[self.type.long()]

    def group_mask(self, groupbit: int) -> torch.Tensor:
        """[cap] bool membership for a group bit pattern
        (ref: `mask[i] & groupbit`, src/fix_nve.cpp:76)."""
        return (self.mask & groupbit) != 0

    def replace(self, **kwargs) -> "State":
        return dataclasses.replace(self, **kwargs)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def create_state(
    x: np.ndarray,
    box: Box,
    types: np.ndarray | None = None,
    velocities: np.ndarray | None = None,
    masses: np.ndarray | None = None,
    units_name: str = "lj",
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> State:
    """Build a 3-d State from host (numpy) setup data, padded to a
    multiple of 8 rows with tags 1..n. Floats are rounded to `dtype` in
    numpy, as the JAX package does, so both packages hold the same bits."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    cap = round_up(max(n, 1), 8)

    if types is None:
        types = np.ones(n, dtype=np.int32)
    types = np.asarray(types, dtype=np.int32)
    ntypes = int(types.max()) if n else 1
    if masses is None:
        masses = np.ones(ntypes + 1, dtype=np.float64)
    else:
        masses = np.asarray(masses, dtype=np.float64)
        if masses.shape[0] == ntypes:  # per-type list without slot 0
            masses = np.concatenate([[1.0], masses])
    masses = masses.copy()
    masses[0] = 1.0  # padding slot must be finite/nonzero
    if velocities is None:
        velocities = np.zeros((n, 3), dtype=np.float64)
    tags = np.arange(1, n + 1, dtype=np.int32)

    npdt = torch.empty((), dtype=dtype).numpy().dtype

    def dev(a, dt=npdt):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a).astype(dt))).to(device)

    def pad(a, fill, dt, width=None):
        shape = (cap,) if width is None else (cap, width)
        out = np.full(shape, fill, dtype=dt)
        out[:n] = a
        return out

    # padded atoms sit at the box origin; the sorted layout replaces them
    # with distinct sentinels (ops/sortedforce.expand_state)
    xp = np.tile(box.lo.cpu().numpy().astype(np.float64), (cap, 1))
    xp[:n] = x
    groupmask = pad(np.ones(n, dtype=np.int32), 0, np.int32)

    return State(
        x=dev(xp),
        v=dev(pad(velocities, 0.0, np.float64, 3)),
        f=dev(np.zeros((cap, 3))),
        type=dev(pad(types, 0, np.int32), np.int32),
        tag=dev(pad(tags, 0, np.int32), np.int32),
        image=dev(np.zeros((cap, 3), dtype=np.int32), np.int32),
        q=None,
        molecule=None,
        box=box.to(dtype=dtype, device=device),
        mass=dev(masses),
        nlocal=n,
        mask=dev(groupmask, np.int32),
        virial=dev(np.zeros(6)),
        ntimestep=0,
        aux={},
        units_name=units_name,
    )
