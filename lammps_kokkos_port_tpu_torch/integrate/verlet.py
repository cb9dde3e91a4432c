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

On the sorted layout the segment runner steps a carry in place: on the
card its step replays a CUDA graph (integrate/graphs), on the CPU it runs
in a Python loop. The cell buckets, whose decision reads the host, run the
step in a Python loop.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import State
from ..ops import cellforce, sortedforce
from ..ops import neighbor as nbr
from ..utils import trace
from ..utils.units import Units
from . import graphs


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

    def kick(self, state: State) -> torch.Tensor:
        """The half kick's increment of v: dtf/m * f on the group's rows."""
        m = state.per_atom_mass[:, None]
        return torch.where(self._gmask(state), self.dtf * state.f / m, 0.0)

    def drift(self, state: State) -> torch.Tensor:
        """The drift's increment of x: dt*v on the group's rows."""
        return torch.where(self._gmask(state), self.dt * state.v, 0.0)

    def nve_v(self, state: State) -> State:
        """v += dtf/m * f (ref: FixNVE half kick)."""
        return state.replace(v=state.v + self.kick(state))

    def nve_x(self, state: State) -> State:
        """x += dt*v (ref: FixNVE drift)."""
        return state.replace(x=state.x + self.drift(state))

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


# the list's device tensors the generic step carries and hands out, and
# `short_need`, carried too and copied back into the caller's (the host
# reads it after a short-list overflow)
LIST_FIELDS = ("ago", "nbuilds", "overflow", "xhold")
CARRIED = LIST_FIELDS + ("short_need",)


class _Carry:
    """The generic step on the sorted layout, on a carry: the state and its
    list in buffers of their own, which `step` updates in place
    (integrate/graphs).

    `step` is `make_step`'s step with the kicks and the drift added in
    place (`Integrator.kick`'s and `drift`'s increments: the same
    additions as `nve_v` and `nve_x`, so the same bits) and the force
    pass's forces copied into the carry's f."""

    def __init__(self, state: State, nl, integrator: Integrator, force_fn):
        self.state = graphs.own_state(state)
        self.nl = graphs.own_list(nl, CARRIED)
        self.integrator, self.force_fn = integrator, force_fn

    def load(self, state: State, nl) -> None:
        graphs.load(self.state, self.nl, state, nl, graphs.ROWS, CARRIED)

    def step(self) -> None:
        """Kick, drift, the rebuild decision and re-bin (in place on the
        card; the plain version's fresh arrays are copied in), the force
        pass, kick."""
        st, integ = self.state, self.integrator
        st.v.add_(integ.kick(st))
        st.x.add_(integ.drift(st))
        rebuild = sortedforce.needs_rebuild(st, self.nl)
        out, nl = sortedforce.rebuild_if(st, self.nl, rebuild)
        graphs.keep(st, out, graphs.ROWS)
        graphs.keep(self.nl, nl, CARRIED)
        st.f.copy_(self.force_fn(st, self.nl, False, False)[0])
        st.v.add_(integ.kick(st))

    def unload(self, state: State, nl):
        if nl.short_need is not None:
            nl.short_need.copy_(self.nl.short_need)
        return graphs.unload(self.state, self.nl, state, nl, graphs.ROWS,
                             LIST_FIELDS)


def make_step_segment(integrator: Integrator, force_fn):
    """Segment runner (state, nl, nsteps) -> (state, nl) of `make_step`'s
    step. For the sorted layout the segment leaves the state and list it
    is given as they were: it steps a carry of its own (`_Carry`), loaded
    at its start, and returns clones of it; the returned list keeps `ago`
    and `nbuilds` on the device (`list_ops(nl).read_back` brings them to
    the host with the overflow flag). A set overflow flag NaN-poisons the
    returned positions.

    On the card the carry is the runner's own and its step replays a CUDA
    graph (the first step of a new layout runs eagerly and is captured;
    counted on `segment.graph_steps`). Elsewhere, and in `runner.eager`
    (the tests' reference on the card), a fresh carry's steps run in a
    Python loop; the cell buckets run `make_step`'s step in a loop."""
    step = make_step(integrator, force_fn)
    cache = graphs.Graphs()

    def segment(state: State, nl, nsteps: int, graphed: bool):
        if not isinstance(nl, sortedforce.SortedCells):
            for _ in range(nsteps):
                state, nl = step(state, nl)
        else:
            def make():
                return _Carry(state, nl, integrator, force_fn)

            carry = (cache.use(graphs.layout_key(state, nl), state.device,
                               make) if graphed else make())
            carry.load(state, nl)
            if graphed:
                trace.count("segment.graph_steps", nsteps)
                cache.run("step", nsteps)
            else:
                for _ in range(nsteps):
                    carry.step()
            state, nl = carry.unload(state, nl)
        state = state.replace(ntimestep=state.ntimestep + nsteps)
        return nbr.poison_on_overflow(state, nl), nl

    def runner(state: State, nl, nsteps: int):
        return segment(state, nl, nsteps, state.device.type == "cuda")

    def eager(state: State, nl, nsteps: int):
        return segment(state, nl, nsteps, False)

    runner.eager = eager
    return runner
