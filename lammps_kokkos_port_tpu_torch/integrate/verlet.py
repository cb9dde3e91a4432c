"""Velocity-Verlet NVE integrator (fix nve semantics, group-aware).

Port of the `Integrator` base of `lammps_kokkos_port_tpu/integrate/
verlet.py` (ref: src/fix_nve.cpp:64-141). The hot loop lives in
integrate/fused.py; this class carries the constants it needs.
"""

from __future__ import annotations

import dataclasses

from ..core.state import State
from ..utils.units import Units


@dataclasses.dataclass(frozen=True)
class Integrator:
    dt: float
    units: Units
    groupbit: int = 1  # group "all"

    @property
    def dtf(self) -> float:
        return 0.5 * self.dt * self.units.ftm2v

    def setup(self, state: State) -> State:
        """Install any internal (aux) state before the run starts."""
        return state

    def refresh_segment(self, state: State) -> State:
        """Per-run re-setup hook (ref: FixNH::setup once per `run`)."""
        return state
