"""Neighbor bookkeeping: cell grid sizing and cell binning.

Port of the parts of `lammps_kokkos_port_tpu/ops/neighbor.py` that the
sorted cell-major layout and the dense cell buckets of list mode "cell"
use (ref: src/neighbor.cpp, src/nbin_standard.cpp,
and the Kokkos clamp/count/grow/rerun idiom of
src/KOKKOS/npair_kokkos.cpp:225-330). Shapes are fixed by NeighborParams;
capacity overflow sets a flag on the device that the host reads at segment
ends and heals by growing and re-running. The [N,K] neighbor-matrix engine
is not ported: the JAX package is the oracle the port is tested against.

Binning is sort-based (stable argsort by cell id + rank-in-cell), so the
row layout equals the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.state import State


@dataclasses.dataclass(frozen=True)
class NeighborParams:
    """Static neighbor configuration. `cutneigh` = max force cutoff + skin
    (ref: neighbor->cutneighmax). Rebuild policy mirrors `neigh_modify every
    E delay D check yes/no` (ref: src/neighbor.cpp:2309-2404). `K` (the
    neighbor-matrix width) and `images` serve the JAX package's matrix
    engine; the port computes them the same way so both packages' params
    compare field for field."""

    cutneigh: float
    skin: float
    every: int = 1
    delay: int = 0
    check: bool = True
    K: int = 64  # neighbor matrix width (grown alongside cell_cap)
    cell_cap: int = 32  # max atoms per cell
    ncells: tuple[int, int, int] = (0, 0, 0)
    images: tuple[int, int, int] = (0, 0, 0)

    @property
    def total_cells(self) -> int:
        nx, ny, nz = self.ncells
        return nx * ny * nz


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def box_heights(box) -> np.ndarray:
    """Perpendicular distances between periodic lattice planes, per dim,
    computed from the cell matrix exactly as the JAX package does (for an
    orthogonal box this is prd, up to the rounding of that formula)."""
    h = np.diag(_host(box.prd))
    vol = abs(np.linalg.det(h))
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    return np.array([
        vol / np.linalg.norm(np.cross(b, c)),
        vol / np.linalg.norm(np.cross(a, c)),
        vol / np.linalg.norm(np.cross(a, b)),
    ])


def choose_grid(box, cutneigh: float) -> tuple[int, int, int]:
    """Largest grid whose cells span >= cutneigh along each dimension;
    (0,0,0) when any dim has fewer than 3 cells."""
    nc = np.maximum(1, np.floor(box_heights(box) / cutneigh).astype(int))
    if np.any(nc < 3):
        return (0, 0, 0)
    return (int(nc[0]), int(nc[1]), int(nc[2]))


def _bin_atoms(state: State, p: NeighborParams):
    """Assign atoms to cells and build dense per-cell buckets.

    Returns (cell_coords [cap,3] int32, buckets [ntot+1, cell_cap] int32,
    cell_overflow 0-d bool tensor). Bucket entries == cap are padding; atoms
    ranked past cell_cap in a full cell are dropped (and flagged), which is
    what the JAX scatter's mode="drop" does implicitly.
    """
    cap = state.capacity
    nx, ny, nz = p.ncells
    ntot = p.total_cells
    dev = state.device

    lamda = state.box.to_lamda(state.x)
    frac = lamda - torch.floor(lamda)
    frac = torch.clamp(frac, 0.0, 1.0 - 1e-7)
    dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    c = torch.floor(frac * dims.to(frac.dtype)).to(torch.int32)
    c = torch.minimum(torch.clamp(c, min=0), dims - 1)

    cid = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
    cid = torch.where(state.valid_mask, cid, ntot)

    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(cap, device=dev) - first

    keep = rank < p.cell_cap
    buckets = torch.full((ntot + 1, p.cell_cap), cap, dtype=torch.int32,
                         device=dev)
    buckets[sorted_cid[keep].long(), rank[keep]] = order[keep].to(torch.int32)

    counts = torch.bincount(cid.long(), minlength=ntot + 1)
    cell_overflow = counts[:ntot].max() > p.cell_cap
    return c, buckets, cell_overflow


def poison_on_overflow(state: State, nl):
    """If the segment ended with the sticky overflow flag set, return NaN
    positions, so a caller that bypasses the grow-retry contract sees loud
    non-finite output instead of corrupt physics (Simulation's retry loop
    checks the flag first and discards this state)."""
    nan = torch.full((), float("nan"), dtype=state.dtype, device=state.device)
    return state.replace(x=torch.where(nl.overflow, nan, state.x))


# ---------------------------------------------------------------------------
# Host-side capacity management (the grow-and-retry loop)
# ---------------------------------------------------------------------------


def size_for_system(
    state: State,
    cutneigh: float,
    skin: float,
    every: int = 1,
    delay: int = 0,
    check: bool = True,
    k_pad: float = 1.25,
    cell_pad: float = 1.6,
    k_round: int = 8,
    cell_round: int = 4,
    ncells: tuple[int, int, int] | None = None,
) -> NeighborParams:
    """Initial padded capacities from host-side counting + density. Any
    underestimate is healed by the runner's overflow-retry loop."""
    if ncells is None:
        ncells = choose_grid(state.box, cutneigh)
    if ncells == (0, 0, 0):
        raise NotImplementedError(
            "box narrower than 3 cells of cutneigh: the all-pairs neighbor "
            "mode is not ported")
    n = state.nlocal

    def round_up(v, m):
        return ((v + m - 1) // m) * m

    counts = np.bincount(_cell_ids_host(state, ncells),
                         minlength=ncells[0] * ncells[1] * ncells[2] + 1)
    max_cell = int(counts[:-1].max())
    cell_cap = round_up(max(int(max_cell * cell_pad) + 1, 4), cell_round)

    vol = float(np.prod(box_heights(state.box)))
    vol_cell = vol / (ncells[0] * ncells[1] * ncells[2])
    dens = max(n / vol, max_cell / vol_cell * 0.7)
    est = 4.0 / 3.0 * np.pi * cutneigh**3 * dens
    K = round_up(max(int(est * k_pad) + 1, 8), k_round)
    K = min(K, state.capacity)

    return NeighborParams(
        cutneigh=cutneigh, skin=skin, every=every, delay=delay, check=check,
        K=K, cell_cap=cell_cap, ncells=ncells,
    )


def grow(p: NeighborParams, factor: float = 1.3) -> NeighborParams:
    """Grow capacities after an overflow (ref: npair_kokkos.cpp grow)."""
    return dataclasses.replace(
        p,
        K=int(p.K * factor) + 8,
        cell_cap=int(p.cell_cap * factor) + 4,
    )


def _cell_ids_host(state: State, ncells) -> np.ndarray:
    """Numpy cell ids for sizing (padded atoms -> dead cell)."""
    nx, ny, nz = ncells
    x = _host(state.x)
    prd = _host(state.box.prd)
    hinv = np.diag(np.asarray(1.0, prd.dtype) / prd)
    lam = (x - _host(state.box.lo)) @ hinv.T
    frac = lam - np.floor(lam)
    frac = np.clip(frac, 0.0, 1.0 - 1e-7)
    c = np.floor(frac * np.array([nx, ny, nz])).astype(np.int64)
    c = np.minimum(c, np.array([nx - 1, ny - 1, nz - 1]))
    cid = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
    return np.where(_host(state.valid_mask), cid, nx * ny * nz)
