"""Grid-roll pair evaluation with energy and virial (thermo steps).

Port of `compute` from `lammps_kokkos_port_tpu/ops/gridforce.py`, for
fully periodic boxes. Positions are gathered once into the cell-major grid
`xg [nx, ny, nz, cc, 3]`; each stencil interaction is a roll of the whole
grid (min_image fixes the box-length offset at the wrap seam). Newton's
third law halves the work: only the 13 lexicographically-positive offsets
are evaluated and the reaction on the neighbor cell is rolled back
(ref: half stencils + reverse comm, src/npair_half_bin_newton.cpp). Plain
PyTorch, as the JAX package left this path to XLA: it runs only on thermo
steps.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import State
from . import neighbor as nbr

# 13 lexicographically-positive offsets (half stencil); the self cell is
# handled separately with a both-orders half weight
HALF_OFFSETS = [
    (i, j, k)
    for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
    if (i, j, k) > (0, 0, 0)
]


@dataclasses.dataclass(frozen=True)
class GridCells:
    """Dense cell buckets (grid-major); entries == capacity are padding."""

    buckets: torch.Tensor  # [ntot+1, cc] int32 atom rows
    params: nbr.NeighborParams


def _roll3(a: torch.Tensor, off, sign: int) -> torch.Tensor:
    return torch.roll(a, shifts=(sign * off[0], sign * off[1],
                                 sign * off[2]), dims=(0, 1, 2))


def compute(style, state: State, cl: GridCells, eflag: bool, vflag: bool):
    """Half-stencil grid-roll pair evaluation for single-type pair_terms
    styles. Returns (f, pe, virial); pe/virial are None unless requested."""
    if not all(state.box.periodic) or style.ntypes != 1:
        raise NotImplementedError(
            "grid path ported for periodic boxes and one atom type only")
    p = cl.params
    cap = state.capacity
    nx, ny, nz = p.ncells
    ntot = p.total_cells
    cc = p.cell_cap
    dt = state.dtype
    cutsq = style.cutsq_table()[1, 1]

    # one gather into the cell-major grid (padding entries read row cap-1
    # and are masked by vg)
    own_idx = cl.buckets[:ntot].long()
    bidx = torch.clamp(own_idx, max=cap - 1)
    xg = state.x[bidx].reshape(nx, ny, nz, cc, 3)
    vg = (own_idx < cap).reshape(nx, ny, nz, cc)
    og = state.owned_mask[bidx].reshape(nx, ny, nz, cc) & vg

    def pair_block(xi, xj, vi, vj, oi, oj, pair_mask, once):
        """Dense cc_i x cc_j evaluation. once=True: each pair appears once
        (full tally weight split by ownership); False: both orders appear
        (0.5 weight)."""
        dx = state.box.min_image(xi[..., :, None, :] - xj[..., None, :, :])
        r2 = torch.sum(dx * dx, dim=-1)  # [..., cc, cc]
        valid = vi[..., :, None] & vj[..., None, :] & (r2 < cutsq)
        if pair_mask is not None:
            valid = valid & pair_mask
        r2s = torch.where(valid, r2, torch.ones((), dtype=dt,
                                                device=r2.device))
        fpair, evdwl = style.pair_terms(r2s, None, None, eflag)
        fpair = torch.where(valid, fpair, 0.0)
        fij = dx * fpair[..., None]  # force ON i FROM j
        fi = torch.sum(fij, dim=-2)  # [..., cc_i, 3]
        fj = -torch.sum(fij, dim=-3)  # [..., cc_j, 3]

        pe = vir = None
        if eflag or vflag:
            wi = oi[..., :, None].to(dt)
            wj = oj[..., None, :].to(dt)
            w = (wi + wj) * 0.5 if once else (wi + wj) * 0.5 * 0.5
        if eflag:
            pe = torch.sum(torch.where(valid, evdwl * w, 0.0))
        if vflag:
            wf = fpair * w
            vir = torch.stack([
                torch.sum(wf * dx[..., 0] * dx[..., 0]),
                torch.sum(wf * dx[..., 1] * dx[..., 1]),
                torch.sum(wf * dx[..., 2] * dx[..., 2]),
                torch.sum(wf * dx[..., 0] * dx[..., 1]),
                torch.sum(wf * dx[..., 0] * dx[..., 2]),
                torch.sum(wf * dx[..., 1] * dx[..., 2]),
            ])
        return fi, fj, pe, vir

    pe_tot = torch.zeros((), dtype=dt, device=state.device)
    vir_tot = torch.zeros(6, dtype=dt, device=state.device)

    # self cell: both (i,j) and (j,i) orders appear; mask the diagonal
    lane = torch.arange(cc, device=state.device)
    notself = lane[:, None] != lane[None, :]
    f_grid, _, pe, vir = pair_block(xg, xg, vg, vg, og, og, notself,
                                    once=False)
    if eflag:
        pe_tot = pe_tot + pe
    if vflag:
        vir_tot = vir_tot + vir

    # 13 half-stencil offsets: evaluate once, roll the reaction back
    for off in HALF_OFFSETS:
        xj = _roll3(xg, off, -1)
        vj = _roll3(vg, off, -1)
        oj = _roll3(og, off, -1)
        fi, fj, pe, vir = pair_block(xg, xj, vg, vj, og, oj, None,
                                     once=True)
        f_grid = f_grid + fi + _roll3(fj, off, +1)
        if eflag:
            pe_tot = pe_tot + pe
        if vflag:
            vir_tot = vir_tot + vir

    # scatter back to rows; padding entries (== cap) are dropped
    rows = own_idx.reshape(-1)
    keep = rows < cap
    f = torch.zeros_like(state.x)
    f[rows[keep]] = f_grid.reshape(-1, 3)[keep]
    return f, (pe_tot if eflag else None), (vir_tot if vflag else None)
