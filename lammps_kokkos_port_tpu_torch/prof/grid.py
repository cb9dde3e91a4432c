"""The sorted-kernel scripts' inputs, built from a set-up sorted Simulation.

Counterpart of the set-up lines of benchmarks/prof/prof_sorted_ablate.py
(:51-60) and prof_v3_32k.py (:24-34): float ids `where(valid, row, -1)` in
the state's dtype, the box lengths, and the channels x, y, z, id in the
column layout `[nx*ny, nz, cc]` and the plane layout `[nx, ny, nz, cc]`.
Both layouts are views of one contiguous `[4, cap]` buffer in the
cell-major row order (cx*ny + cy)*nz + cz that the sorted state and
`ops/pair_kernels.lj_cell_force` use.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import sortedforce
from ..presets import lj_melt_sim


@dataclasses.dataclass(frozen=True)
class SortedPlanes:
    ncells: tuple  # (nx, ny, nz)
    cc: int  # rows per cell
    natoms: int
    key: tuple  # the pair style's kernel_key()
    prd: torch.Tensor  # [3], the state's dtype
    buf: torch.Tensor  # [4, cap]: x, y, z, float id (-1 for padding)

    @property
    def cap(self) -> int:
        return self.buf.shape[1]

    @property
    def ids(self) -> torch.Tensor:
        return self.buf[3]

    @property
    def flat(self) -> tuple:
        """(gx, gy, gz, gi), each [nx*ny*nz, cc]."""
        return tuple(self.buf.reshape(4, -1, self.cc).unbind(0))

    @property
    def col(self) -> tuple:
        """(gx, gy, gz, gi), each [nx*ny, nz, cc]."""
        nx, ny, nz = self.ncells
        return tuple(self.buf.reshape(4, nx * ny, nz, self.cc).unbind(0))

    @property
    def plane(self) -> tuple:
        """(gx, gy, gz, gi), each [nx, ny, nz, cc]."""
        return tuple(self.buf.reshape(4, *self.ncells, self.cc).unbind(0))


def melt_sim(cells: int, device):
    """The scripts' simulation, set up: the bench/in.lj melt of `cells`
    fcc cells per side, `lj_melt_sim(cells, t_init=1.44, seed=87287,
    every=20, delay=0, check=False)` in f32 on `device`."""
    sim = lj_melt_sim(cells=cells, t_init=1.44, seed=87287,
                      dtype=torch.float32, every=20, delay=0, check=False,
                      device=device)
    sim.setup()
    return sim


def resort(sim, cell_cap: int):
    """prof_kernel_cc32.py:50-54: the sorted state re-sorted at a forced
    `cell_cap` (sortedforce.expand_state, then build). Returns (state,
    params); raises when a cell holds more atoms than `cell_cap`."""
    p = dataclasses.replace(sim.nl.params, cell_cap=cell_cap)
    state, cl = sortedforce.build(sortedforce.expand_state(sim.state, p), p)
    if bool(cl.overflow):
        raise RuntimeError(f"cell_cap {cell_cap} overflowed")
    return state, p


def sorted_planes(sim, x: torch.Tensor | None = None,
                  dtype: torch.dtype | None = None,
                  cell_cap: int | None = None) -> SortedPlanes:
    """The scripts' inputs from a set-up sorted `Simulation`; `x` [cap, 3]
    replaces the state's positions (e.g. jittered ones); `dtype` is the
    planes' float type (default: the state's); `cell_cap` re-sorts the state
    at that cell capacity first (`resort`; `x` then replaces the re-sorted
    positions)."""
    if sim.nl is None or sim.list_mode != "sorted":
        raise ValueError("sorted_planes needs a set-up Simulation in list "
                         "mode 'sorted'")
    st, p = sim.state, sim.nl.params
    if cell_cap is not None:
        st, p = resort(sim, cell_cap)
    x = st.x if x is None else x
    dtype = dtype or st.dtype
    cap = st.capacity
    ids = torch.where(st.valid_mask,
                      torch.arange(cap, device=st.device), -1).to(dtype)
    buf = torch.cat([x.t().to(dtype), ids[None]]).contiguous()
    return SortedPlanes(ncells=tuple(p.ncells), cc=p.cell_cap,
                        natoms=st.nlocal, key=sim.pair_style.kernel_key(),
                        prd=st.box.prd.to(dtype), buf=buf)
