"""Thermodynamic observables: temperature, kinetic energy, pressure.

Port of `lammps_kokkos_port_tpu/compute/thermo.py` (ref:
src/compute_temp.cpp, src/compute_pressure.cpp, src/thermo.cpp). Pure
functions of the state and a fresh virial; evaluated only on output steps.
They return 0-d or [6] tensors on the state's device.
"""

from __future__ import annotations

import torch

from ..core.state import State
from ..utils.units import Units


def _ke2(state: State) -> torch.Tensor:
    """sum over atoms of m v^2."""
    m = state.per_atom_mass
    return torch.sum(torch.where(state.valid_mask,
                                 m * torch.sum(state.v * state.v, dim=-1),
                                 0.0))


def _dof(state: State) -> float:
    """dim*N - dim: the default extra_dof is the dimension
    (ref: src/compute.cpp:84)."""
    return float(state.dimension * (state.nlocal - 1))


def temperature(state: State, units: Units) -> torch.Tensor:
    """T = sum(m v^2) mvv2e / (dof kB) (ref: src/compute_temp.cpp:58-100)."""
    return _ke2(state) * (units.mvv2e / (_dof(state) * units.boltz))


def kinetic_energy(state: State, units: Units) -> torch.Tensor:
    """KE = 0.5 mvv2e sum(m v^2) (ref: src/thermo.cpp compute_ke)."""
    return 0.5 * units.mvv2e * _ke2(state)


def pressure(state: State, virial: torch.Tensor, units: Units,
             t: torch.Tensor) -> torch.Tensor:
    """P = (dof kB T + vxx+vyy+vzz) / (3 V) * nktv2p for temperature t
    (ref: src/compute_pressure.cpp compute_scalar)."""
    vtrace = virial[0] + virial[1] + virial[2]
    return ((_dof(state) * units.boltz * t + vtrace)
            / (3 * state.box.volume) * units.nktv2p)


def pressure_tensor(state: State, virial6: torch.Tensor,
                    units: Units) -> torch.Tensor:
    """Voigt pressure tensor (xx,yy,zz,xy,xz,yz) incl. kinetic part
    (ref: src/compute_pressure.cpp compute_vector)."""
    m = state.per_atom_mass
    v = torch.where(state.valid_mask[:, None], state.v, 0.0)
    pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
    kin = torch.stack([torch.sum(m * v[:, a] * v[:, b]) for a, b in pairs])
    return (kin * units.mvv2e + virial6) / state.box.volume * units.nktv2p
