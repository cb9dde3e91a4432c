"""Cell-dense force path (list mode "cell"): dense per-cell buckets over a
state kept in atom order.

Port of `lammps_kokkos_port_tpu/ops/cellforce.py`, after the reference's
Kokkos GPU path that teams over bins (ref: src/KOKKOS/nbin_kokkos.cpp dense
bins, src/KOKKOS/npair_kokkos.cpp):

  - rebuild: bin atoms into dense buckets [ncells+1, cell_cap] with the
    sort-based `neighbor._bin_atoms`; the state itself is not permuted;
  - `compute` is lj/cut's force path on the buckets (the style's "cell"
    mode, models/pair_lj): force-only passes (every MD step) of a single
    type go to the CUDA kernel of ops/cell_kernels (K6), at every grid
    size;
  - energy/virial passes (thermo steps) and several types take the plain
    PyTorch path below: for each chunk of cells, gather the own rows and
    the 27 stencil cells' rows and evaluate every candidate pair with
    masks, as the JAX package leaves it to XLA.

The rebuild decision is made on the host (`needs_rebuild` returns a bool):
the cadence of `neigh_modify every/delay` is known there, and with `check
yes` the displacement test reads one device flag on cadence steps only. A
decision kept on the device would have to run the rebuild (a stable
argsort of every atom's cell id) on every step.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from ..core.state import State
from ..utils import trace
from . import neighbor as nbr


@dataclasses.dataclass(frozen=True)
class CellListDense:
    """Dense cell buckets and the rebuild bookkeeping. `ago` and `nbuilds`
    are host ints; `overflow` is a sticky 0-d bool tensor on the device.
    (The JAX version's `ndanger` counter is not ported: no list mode of
    the JAX package ever counts one.)"""

    list_mode: ClassVar[str] = "cell"

    buckets: torch.Tensor  # [ntot+1, cell_cap] int32 atom rows (cap = empty)
    stencil: torch.Tensor  # [ntot, 27] int32 neighbour cell ids (ntot = dead)
    xhold: torch.Tensor  # positions at the last rebuild
    ago: int
    nbuilds: int
    overflow: torch.Tensor
    params: nbr.NeighborParams


def _stencil_table(p: nbr.NeighborParams, periodic) -> np.ndarray:
    """[ntot, 27] neighbour cell ids; across a non-periodic face the dead
    cell id ntot."""
    nx, ny, nz = p.ncells
    ntot = p.total_cells
    offs = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1)])
    cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    cells = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)
    out = np.zeros((ntot, 27), dtype=np.int32)
    dims = np.array([nx, ny, nz])
    for s, off in enumerate(offs):
        nc = cells + off
        dead = np.zeros(len(cells), dtype=bool)
        for d in range(3):
            if not periodic[d]:
                dead |= (nc[:, d] < 0) | (nc[:, d] >= dims[d])
        ncw = np.mod(nc, dims)
        cid = (ncw[:, 0] * ny + ncw[:, 1]) * nz + ncw[:, 2]
        out[:, s] = np.where(dead, ntot, cid)
    return out


@trace.spanned("neigh")
def build_cell(state: State, p: nbr.NeighborParams,
               stencil: torch.Tensor | None = None) -> CellListDense:
    """Bin atoms into dense buckets (no host read)."""
    _, buckets, cell_overflow = nbr._bin_atoms(state, p)
    if stencil is None:
        stencil = torch.from_numpy(
            _stencil_table(p, state.box.periodic)).to(state.device)
    return CellListDense(buckets=buckets, stencil=stencil, xhold=state.x,
                         ago=0, nbuilds=1, overflow=cell_overflow, params=p)


def rebuild_merge(state: State, old: CellListDense) -> CellListDense:
    trace.count("neigh.rebin_passes")
    new = build_cell(state, old.params, stencil=old.stencil)
    return dataclasses.replace(new, nbuilds=old.nbuilds + 1,
                               overflow=old.overflow | new.overflow)


def tick(cl: CellListDense) -> CellListDense:
    return dataclasses.replace(cl, ago=cl.ago + 1)


@trace.spanned("neigh")
def needs_rebuild(state: State, cl: CellListDense) -> bool:
    """The decision of `neigh_modify every E delay D check yes/no` (ref:
    Neighbor::decide, src/neighbor.cpp:2309-2404): the cadence on the
    host, and with `check yes`, on cadence steps only, a host read of
    whether any atom moved more than skin/2 since the last rebuild."""
    p = cl.params
    ago = cl.ago + 1
    cadence = ago >= p.delay and ago % max(p.every, 1) == 0
    if not cadence or not p.check:
        return cadence
    half_skin_sq = (0.5 * p.skin) ** 2
    disp = state.x - cl.xhold
    d2 = torch.where(state.valid_mask, torch.sum(disp * disp, dim=-1), 0.0)
    return bool(torch.max(d2) > half_skin_sq)


def read_back(cl: CellListDense) -> tuple[bool, CellListDense]:
    """A segment's one host read: the overflow flag."""
    return bool(cl.overflow), cl


def compute(style, state: State, cl: CellListDense, eflag: bool,
            vflag: bool, cell_chunk: int = 128):
    """Dense per-cell pair evaluation for lj/cut (`pair_terms`). Returns
    (f, pe, virial); pe/virial are None unless requested. Atoms in no
    bucket (padding) get zero force."""
    if not eflag and not vflag:
        key = style.kernel_key()
        if key is not None:
            from .cell_kernels import lj_cell_dense

            return (lj_cell_dense(key, cl.buckets, cl.stencil, state.x,
                                  state.box.prd.to(state.dtype)),
                    None, None)

    p = cl.params
    cap = state.capacity
    ntot = p.total_cells
    cc = p.cell_cap
    dt = state.dtype
    single = style.ntypes == 1
    cutsq_tab = style.cutsq_table()
    owned = state.owned_mask

    # one row gather of all atoms into the bucket layout; the chunks read
    # whole [cc, 3] cell blocks from it
    valid_b = cl.buckets < cap
    bidx = torch.clamp(cl.buckets, max=cap - 1).long()
    xb = state.x[bidx]  # [ntot+1, cc, 3]
    tb = None if single else state.type[bidx]

    f = torch.zeros_like(state.x)
    pes, virs = [], []
    for c0 in range(0, ntot, cell_chunk):
        cids = slice(c0, min(c0 + cell_chunk, ntot))
        own_idx = cl.buckets[cids]  # [chunk, cc]
        own_x = xb[cids]
        own_valid = valid_b[cids]
        nch = own_idx.shape[0]
        n27 = cl.stencil[cids].long()  # [chunk, 27]
        cand_idx = cl.buckets[n27].reshape(nch, 27 * cc)
        cand_x = xb[n27].reshape(nch, 27 * cc, 3)
        cand_valid = valid_b[n27].reshape(nch, 27 * cc)

        dx = state.box.min_image(own_x[:, :, None, :] - cand_x[:, None, :, :])
        r2 = torch.sum(dx * dx, dim=-1)  # [chunk, cc, 27cc]
        if single:
            ti = tj = None
            cutsq = cutsq_tab[1, 1]
        else:
            ti = tb[cids][:, :, None]
            tj = tb[n27].reshape(nch, 27 * cc)[:, None, :]
            cutsq = cutsq_tab[ti.long(), tj.long()]

        self_mask = own_idx[:, :, None] == cand_idx[:, None, :]
        valid = (own_valid[:, :, None] & cand_valid[:, None, :]
                 & ~self_mask & (r2 < cutsq))
        r2s = torch.where(valid, r2, torch.ones((), dtype=dt,
                                                device=state.device))
        fpair, evdwl = style.pair_terms(r2s, ti, tj, eflag)
        fpair = torch.where(valid, fpair, 0.0)
        fch = torch.sum(dx * fpair[..., None], dim=2)  # [chunk, cc, 3]
        f[own_idx[own_valid].long()] = fch[own_valid]

        own_owned = owned[bidx[cids]] & own_valid
        if eflag:
            pes.append(0.5 * torch.sum(torch.where(
                valid & own_owned[:, :, None], evdwl, 0.0)))
        if vflag:
            w = 0.5 * torch.where(own_owned[:, :, None], fpair, 0.0)
            virs.append(torch.stack([
                torch.sum(w * dx[..., 0] * dx[..., 0]),
                torch.sum(w * dx[..., 1] * dx[..., 1]),
                torch.sum(w * dx[..., 2] * dx[..., 2]),
                torch.sum(w * dx[..., 0] * dx[..., 1]),
                torch.sum(w * dx[..., 0] * dx[..., 2]),
                torch.sum(w * dx[..., 1] * dx[..., 2]),
            ]))
    pe = torch.stack(pes).sum() if eflag else None
    vir = torch.stack(virs).sum(dim=0) if vflag else None
    return f, pe, vir
