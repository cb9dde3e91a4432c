"""Fused planar NVE segment for the sorted (cell-major) state mode.

Port of `lammps_kokkos_port_tpu/integrate/fused.py` (`runner_static`, the
cadence-only rebuild schedule of `neigh_modify ... check no`). The carry
is the planar layout: x, v, f as contiguous [3, cap] tensors, so each
component is a [ncells, cell_cap] grid the force kernel reads directly.
Per-row kick factors dtfm = dtf/m and drift factors are computed once per
rebuild (the reference's per-atom `dtfm`, src/fix_nve.cpp:64-141), and the
full State is only reassembled on rebuild steps and at the segment end.
Between rebuilds a step is: kick, drift, one force kernel, kick
(ref: the fused final+initial integrate of src/KOKKOS/verlet_kokkos.cpp).

The rebuild schedule is known on the host, so the only host/device
synchronisation of a segment is the caller's read of the overflow flag at
its end. The carry lives in buffers that the two kinds of step (`plain`
and `rebuild`) update in place: on the card each kind is captured in a
CUDA graph and replayed, the host picking which from the cadence
(integrate/graphs); on the CPU the steps run in a Python loop.
Distance-checked policies (`check yes`, delay > every) run through the
generic step of integrate/verlet.py instead.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import State
from ..ops import neighbor as nbr
from ..ops import sortedforce
from ..ops.pair_kernels import lj_cell_force
from ..utils import trace
from . import graphs


@trace.spanned("pair")
def force_planar(key, params: nbr.NeighborParams, xs: torch.Tensor,
                 prd: torch.Tensor) -> torch.Tensor:
    """[3, cap] planar positions -> [3, cap] forces via the cell kernel."""
    g = xs.reshape(3, params.total_cells, params.cell_cap)
    return lj_cell_force(key, params.ncells, g[0], g[1], g[2],
                         prd).reshape(3, -1)


# the rows the re-bin moves besides x and v, and the list's tensors the
# segment carries
MOVED = ("type", "tag", "image", "mask", "q", "molecule")
LIST_FIELDS = ("overflow", "xhold")


class _Carry:
    """The fused segment's carry: planar x, v, f ([3, cap]), the per-row
    kick and drift factors, the box lengths, the rows the re-bin moves and
    the list's overflow flag and xhold, in buffers of their own that
    `plain` and `rebuild` (one step each) update in place."""

    def __init__(self, state: State, nl, key, integrator):
        self.key, self.params = key, nl.params
        self.dt, self.dtf = integrator.dt, integrator.dtf
        self.groupbit = integrator.groupbit
        planar = (3, state.capacity)
        self.xs, self.vs, self.fs = (state.x.new_empty(planar)
                                     for _ in range(3))
        # the rows as the re-bin takes them: x, v and f are views of the
        # planar buffers
        self.st = graphs.own_state(state, MOVED).replace(
            x=self.xs.t(), v=self.vs.t(), f=self.fs.t())
        self.nl = graphs.own_list(nl, LIST_FIELDS)
        self.dtfm = state.x.new_empty(state.capacity)
        self.dtv = state.x.new_empty(state.capacity)
        self.prd = state.x.new_empty(3)

    def load(self, state: State, nl) -> None:
        graphs.load(self.st, self.nl, state, nl, MOVED, LIST_FIELDS)
        for buf, rows in ((self.xs, state.x), (self.vs, state.v),
                          (self.fs, state.f)):
            buf.copy_(rows.t())
        self.prd.copy_(state.box.prd)
        self._factors()

    def _factors(self) -> None:
        """dtfm = dtf/m and dt on the group's rows, 0 elsewhere."""
        st = self.st
        gm = st.valid_mask & st.group_mask(self.groupbit)
        zero = torch.zeros((), dtype=st.dtype, device=st.device)
        self.dtfm.copy_(torch.where(gm, self.dtf / st.per_atom_mass, zero))
        self.dtv.copy_(torch.where(gm, torch.full(
            (), self.dt, dtype=st.dtype, device=st.device), zero))

    def _force_and_kick(self) -> None:
        self.fs.copy_(force_planar(self.key, self.params, self.xs, self.prd))
        self.vs.addcmul_(self.dtfm, self.fs)

    def plain(self) -> None:
        """Kick, drift, force, kick."""
        self.vs.addcmul_(self.dtfm, self.fs)
        self.xs.addcmul_(self.dtv, self.vs)
        self._force_and_kick()

    def rebuild(self) -> None:
        """Kick, drift, wrap and re-bin (ops/sortedforce.rebuild_state),
        force, kick."""
        self.vs.addcmul_(self.dtfm, self.fs)
        self.xs.addcmul_(self.dtv, self.vs)
        st = self.st
        x, image = st.box.wrap(st.x, st.image)
        st, nl = sortedforce.rebuild_state(st.replace(x=x, image=image),
                                           self.nl)
        graphs.keep(self.st, st, MOVED)
        graphs.keep(self.nl, nl, LIST_FIELDS)
        self.xs.copy_(st.x.t())
        self.vs.copy_(st.v.t())
        self._factors()
        self._force_and_kick()

    def unload(self, state: State, nl, ago: int, nbuilds: int,
               nsteps: int):
        state, nl = graphs.unload(self.st, self.nl, state, nl, MOVED,
                                  LIST_FIELDS)
        state = state.replace(x=self.xs.t().contiguous(),
                              v=self.vs.t().contiguous(),
                              f=self.fs.t().contiguous(),
                              ntimestep=state.ntimestep + nsteps)
        nl = dataclasses.replace(nl, ago=ago, nbuilds=nbuilds)
        return nbr.poison_on_overflow(state, nl), nl


def make_sorted_nve_segment(integrator, style):
    """Segment runner (state, nl, nsteps) -> (state, nl) for sorted mode
    with a plain NVE integrator and no fixes. Matches the JAX ordering
    exactly: kick+drift, rebuild (wrap + re-bin) on cadence steps, force,
    final kick. The state and list it is given are left as they were.

    On the card the carry is the runner's own, loaded at the segment's
    start, and each kind of step replays its CUDA graph (the first of a
    new layout runs eagerly and is captured; counted on
    `segment.graph_steps`). Elsewhere, and in `runner.eager` (the tests'
    reference on the card), a fresh carry's steps run in a Python loop."""
    key = style.kernel_key()
    cache = graphs.Graphs()

    def segment(state: State, nl: sortedforce.SortedCells, nsteps: int,
                graphed: bool):
        p = nl.params
        every = max(p.every, 1)
        if p.check or p.delay > every:
            # the rebuild schedule is not known on the host: the generic
            # step (integrate/verlet.make_step) decides on the device
            raise NotImplementedError(
                "the fused segment supports `neigh_modify check no` with "
                "delay <= every only; use verlet.make_step_segment")

        def make():
            return _Carry(state, nl, key, integrator)

        if graphed:
            carry = cache.use(graphs.layout_key(state, nl), state.device,
                              make)
            trace.count("segment.graph_steps", nsteps)
            run = cache.run
        else:
            carry = make()

            def run(kind, n):
                for _ in range(n):
                    getattr(carry, kind)()

        carry.load(state, nl)
        ago, nbuilds = nl.ago, nl.nbuilds
        # the first rebuild fires at the step where (ago+1) % every == 0
        until_rebuild = every - (ago % every)
        left = nsteps
        while left:
            if until_rebuild == 1:
                run("rebuild", 1)
                until_rebuild, ago, nbuilds, n = every, 0, nbuilds + 1, 1
            else:
                n = min(until_rebuild - 1, left)
                run("plain", n)
                until_rebuild, ago = until_rebuild - n, ago + n
            left -= n
        return carry.unload(state, nl, ago, nbuilds, nsteps)

    def runner(state: State, nl: sortedforce.SortedCells, nsteps: int):
        return segment(state, nl, nsteps, state.device.type == "cuda")

    def eager(state: State, nl: sortedforce.SortedCells, nsteps: int):
        return segment(state, nl, nsteps, False)

    runner.eager = eager
    return runner
