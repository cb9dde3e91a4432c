"""Velocity-Verlet NVE integrator (fix nve semantics, group-aware), and the
generic step for the sorted layout and the dense cell buckets.

Port of `lammps_kokkos_port_tpu/integrate/verlet.py` (ref:
src/fix_nve.cpp:64-141, src/verlet.cpp:229-358): `Integrator` and
`make_step`, for plain NVE with no fixes and any pair style. The step
keeps the JAX order: kick and drift, the rebuild decision, the force pass
(`force_fn`), the final kick. Each list type takes the JAX step's
`lax.cond(rebuild, do_rebuild, no_rebuild)` its own way:
  - sorted layout: the decision stays on the device
    (ops/sortedforce.needs_rebuild + rebuild_if), so a segment of steps
    reads the host once, at its end;
  - cell buckets (list mode "cell"): the decision is made on the host
    (ops/cellforce.needs_rebuild) and a rebuild wraps and re-bins
    (`rebuild_merge`) only when it fires; otherwise `tick`.
The cadence-only LJ path of the sorted layout has its own fused segment
(integrate/fused.py).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import State
from ..ops import cellforce, sortedforce
from ..ops import neighbor as nbr
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


def list_ops(nl):
    """The module that owns a list's rebuild bookkeeping and read-back."""
    return (cellforce if isinstance(nl, cellforce.CellListDense)
            else sortedforce)


def make_step(integrator: Integrator, force_fn):
    """step(state, nl) -> (state, nl) for the sorted layout (`nl.ago` and
    `nl.nbuilds` as device tensors) or the dense cell buckets (host ints).
    force_fn(state, nl, eflag, vflag) -> (f, epair, emol, virial), as
    Simulation.force_fn."""

    def step(state: State, nl):
        state = integrator.initial_integrate(state)
        if isinstance(nl, cellforce.CellListDense):
            # the decision is a host bool (ops/cellforce.needs_rebuild);
            # positions are wrapped on rebuild steps only, as in the
            # reference (ref: src/verlet.cpp:262-293)
            if cellforce.needs_rebuild(state, nl):
                x, image = state.box.wrap(state.x, state.image)
                state = state.replace(x=x, image=image)
                nl = cellforce.rebuild_merge(state, nl)
            else:
                nl = cellforce.tick(nl)
        else:
            rebuild = sortedforce.needs_rebuild(state, nl)
            state, nl = sortedforce.rebuild_if(state, nl, rebuild)
        f, _, _, _ = force_fn(state, nl, False, False)
        state = integrator.final_integrate(state.replace(f=f))
        return state, nl

    return step


def make_step_segment(integrator: Integrator, force_fn):
    """Segment runner (state, nl, nsteps) -> (state, nl) built on
    `make_step`. For the sorted layout the segment starts from its own
    copies of what the card's re-bin updates in place
    (sortedforce.segment_copies: the state and list it is given are left
    as they were), and the returned list keeps `ago` and `nbuilds` on the
    device (`list_ops(nl).read_back` brings them to the host with the
    overflow flag); a set overflow flag NaN-poisons the returned
    positions."""
    step = make_step(integrator, force_fn)

    def runner(state: State, nl, nsteps: int):
        if isinstance(nl, sortedforce.SortedCells):
            state, nl = sortedforce.segment_copies(state, nl)
        for _ in range(nsteps):
            state, nl = step(state, nl)
        state = state.replace(ntimestep=state.ntimestep + nsteps)
        return nbr.poison_on_overflow(state, nl), nl

    return runner
