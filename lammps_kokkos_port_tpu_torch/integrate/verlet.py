"""Velocity-Verlet NVE integrator (fix nve semantics, group-aware), and the
generic step for the sorted layout.

Port of `lammps_kokkos_port_tpu/integrate/verlet.py` (ref:
src/fix_nve.cpp:64-141, src/verlet.cpp:229-358): `Integrator` and
`make_step`, for plain NVE with no fixes and any pair style. The step
keeps the JAX order: kick and drift, the rebuild decision, the force pass
(`force_fn`), the final kick. The rebuild decision stays on the device
(ops/sortedforce.needs_rebuild + rebuild_if, the counterpart of the JAX
step's `lax.cond`), so a segment of steps reads the host once, at its end.
The cadence-only LJ path has its own fused segment (integrate/fused.py).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import State
from ..ops import neighbor as nbr
from ..ops import sortedforce
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

    def _gmask(self, state: State) -> torch.Tensor:
        return (state.valid_mask & state.group_mask(self.groupbit))[:, None]

    def nve_v(self, state: State) -> State:
        """v += dtf/m * f (ref: FixNVE half kick)."""
        m = state.per_atom_mass[:, None]
        return state.replace(v=state.v + torch.where(
            self._gmask(state), self.dtf * state.f / m, 0.0))

    def nve_x(self, state: State) -> State:
        """x += dt*v (ref: FixNVE drift)."""
        return state.replace(x=state.x + torch.where(
            self._gmask(state), self.dt * state.v, 0.0))

    def initial_integrate(self, state: State) -> State:
        """Kick + drift (ref: src/fix_nve.cpp:64-100)."""
        return self.nve_x(self.nve_v(state))

    def final_integrate(self, state: State) -> State:
        """Second half kick (ref: src/fix_nve.cpp:109-141)."""
        return self.nve_v(state)


def make_step(integrator: Integrator, force_fn):
    """step(state, nl) -> (state, nl) for the sorted layout, `nl.ago` and
    `nl.nbuilds` as device tensors. force_fn(state, nl, eflag, vflag) ->
    (f, epair, emol, virial), as Simulation.force_fn."""

    def step(state: State, nl: sortedforce.SortedCells):
        state = integrator.initial_integrate(state)
        rebuild = sortedforce.needs_rebuild(state, nl)
        state, nl = sortedforce.rebuild_if(state, nl, rebuild)
        f, _, _, _ = force_fn(state, nl, False, False)
        state = integrator.final_integrate(state.replace(f=f))
        return state, nl

    return step


def make_sorted_step_segment(integrator: Integrator, force_fn):
    """Segment runner (state, nl, nsteps) -> (state, nl) built on
    `make_step`. The returned list keeps `ago` and `nbuilds` on the device
    (ops/sortedforce.read_back brings them to the host with the overflow
    flag); a set overflow flag NaN-poisons the returned positions."""
    step = make_step(integrator, force_fn)

    def runner(state: State, nl: sortedforce.SortedCells, nsteps: int):
        dev = state.device
        nl = dataclasses.replace(
            nl, ago=torch.as_tensor(nl.ago, device=dev),
            nbuilds=torch.as_tensor(nl.nbuilds, device=dev))
        for _ in range(nsteps):
            state, nl = step(state, nl)
        state = state.replace(ntimestep=state.ntimestep + nsteps)
        return nbr.poison_on_overflow(state, nl), nl

    return runner
