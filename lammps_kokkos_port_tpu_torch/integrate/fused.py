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

The loop is plain Python over eager tensor ops. The rebuild schedule is
known on the host, so the only host/device synchronisation of a segment is
the caller's read of the overflow flag at its end. Distance-checked
policies (`check yes`, delay > every) run through the generic step of
integrate/verlet.py instead.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import State
from ..ops import neighbor as nbr
from ..ops import sortedforce
from ..ops.pair_kernels import lj_cell_force
from ..utils import trace


@trace.spanned("pair")
def force_planar(key, params: nbr.NeighborParams, xs: torch.Tensor,
                 prd: torch.Tensor) -> torch.Tensor:
    """[3, cap] planar positions -> [3, cap] forces via the cell kernel."""
    g = xs.reshape(3, params.total_cells, params.cell_cap)
    return lj_cell_force(key, params.ncells, g[0], g[1], g[2],
                         prd).reshape(3, -1)


def make_sorted_nve_segment(integrator, style):
    """Segment runner (state, nl, nsteps) -> (state, nl) for sorted mode
    with a plain NVE integrator and no fixes. Matches the JAX ordering
    exactly: kick+drift, rebuild (wrap + re-bin) on cadence steps, force,
    final kick."""
    key = style.kernel_key()
    dt = integrator.dt
    dtf = integrator.dtf
    groupbit = integrator.groupbit

    def row_factors(st: State):
        gm = st.valid_mask & st.group_mask(groupbit)
        zero = torch.zeros((), dtype=st.dtype, device=st.device)
        dtfm = torch.where(gm, dtf / st.per_atom_mass, zero)
        dtv = torch.where(gm, torch.full((), dt, dtype=st.dtype,
                                         device=st.device), zero)
        return dtfm, dtv

    def runner(state: State, nl: sortedforce.SortedCells, nsteps: int):
        p = nl.params
        every = max(p.every, 1)
        if p.check or p.delay > every:
            # the rebuild schedule is not known on the host: the generic
            # step (integrate/verlet.make_step) decides on the device
            raise NotImplementedError(
                "the fused segment supports `neigh_modify check no` with "
                "delay <= every only; use verlet.make_step_segment")
        prd = state.box.prd.to(state.dtype)
        st = state
        # the card's re-bin raises the overflow flag in place: the
        # segment's own flag, so the caller's list (the grow-retry's
        # snapshot) stays as it was
        nl = dataclasses.replace(nl, overflow=nl.overflow.clone())
        planar = sortedforce.planar
        xs, vs, fs = planar(state.x), planar(state.v), planar(state.f)
        dtfm, dtv = row_factors(state)
        # the first rebuild fires at the step where (ago+1) % every == 0
        until_rebuild = every - (nl.ago % every)

        for _ in range(nsteps):
            vs.addcmul_(dtfm, fs)
            xs.addcmul_(dtv, vs)
            until_rebuild -= 1
            if until_rebuild == 0:
                until_rebuild = every
                st = st.replace(x=xs.t(), v=vs.t())
                x, image = st.box.wrap(st.x, st.image)
                st, nl = sortedforce.rebuild_state(
                    st.replace(x=x, image=image), nl)
                xs, vs = planar(st.x), planar(st.v)
                dtfm, dtv = row_factors(st)
            else:
                nl = sortedforce.tick(nl)
            fs = force_planar(key, p, xs, prd)
            vs.addcmul_(dtfm, fs)

        st = st.replace(x=xs.t().contiguous(), v=vs.t().contiguous(),
                        f=fs.t().contiguous(),
                        ntimestep=st.ntimestep + nsteps)
        return nbr.poison_on_overflow(st, nl), nl

    return runner
