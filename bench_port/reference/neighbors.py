"""Unordered pairs within a distance, from positions alone.

Bins the atoms into a cell grid of edge >= `rlist` (at least 3 cells a
dimension, so the 14 half-stencil offsets name 14 distinct cells), then
tests every atom of a cell against its own cell (lower slot first) and
against the 13 forward neighbour cells. Each unordered pair within `rlist`
is returned once. Distances use the minimum image of an orthogonal
periodic box of lengths `prd`.
"""

from __future__ import annotations

import torch

# the own cell and the 13 forward neighbours: each unordered cell pair once
HALF_OFFSETS = [(0, 0, 0)] + [
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if (dx, dy, dz) > (0, 0, 0)]

# candidate pairs tested at once (rows x lanes x lanes): bounds the memory
BLOCK_CANDIDATES = 1 << 23


def min_image(d: torch.Tensor, prd: torch.Tensor) -> torch.Tensor:
    """Nearest periodic image of displacements `d` [..., 3]."""
    return d - prd * torch.round(d / prd)


def cell_grid(prd, rlist: float) -> tuple[int, int, int]:
    """Cells per dimension: as many as fit with edge >= rlist."""
    nc = tuple(int(float(p) // rlist) for p in prd)
    if min(nc) < 3:
        raise ValueError(f"box {list(map(float, prd))} holds fewer than 3 "
                         f"cells of edge {rlist} in some dimension")
    return nc


def half_pairs(x: torch.Tensor, prd: torch.Tensor, rlist: float):
    """(i, j) int64 index tensors of every unordered pair closer than
    `rlist`, each once. x: [N, 3] positions (any image); prd: [3]."""
    dev = x.device
    n = x.shape[0]
    nx, ny, nz = cell_grid(prd, rlist)
    ncell = nx * ny * nz
    dims = torch.tensor([nx, ny, nz], device=dev)
    frac = x / prd
    frac = frac - torch.floor(frac)
    c = torch.minimum((frac * dims).long(), dims - 1)
    cid = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
    order = torch.argsort(cid, stable=True)
    cs = cid[order]
    counts = torch.bincount(cid, minlength=ncell)
    start = torch.cumsum(counts, 0) - counts
    cap = int(counts.max())
    slot = torch.arange(n, device=dev) - start[cs]
    dense = torch.full((ncell, cap), -1, dtype=torch.long, device=dev)
    dense[cs, slot] = order

    ids = torch.arange(ncell, device=dev)
    cx, cy, cz = ids // (ny * nz), (ids // nz) % ny, ids % nz
    lane = torch.arange(cap, device=dev)
    upper = lane[:, None] < lane[None, :]
    rsq = rlist * rlist
    block = max(1, BLOCK_CANDIDATES // (cap * cap))
    out_i, out_j = [], []
    for ox, oy, oz in HALF_OFFSETS:
        nb = (((cx + ox) % nx) * ny + (cy + oy) % ny) * nz + (cz + oz) % nz
        for a in range(0, ncell, block):
            own = dense[a:a + block]
            cand = dense[nb[a:a + block]]
            d = (x[own.clamp(min=0)][:, :, None, :]
                 - x[cand.clamp(min=0)][:, None, :, :])
            d = min_image(d, prd)
            ok = ((d * d).sum(-1) < rsq) & (own[:, :, None] >= 0) & (
                cand[:, None, :] >= 0)
            if (ox, oy, oz) == (0, 0, 0):
                ok &= upper
            b, li, lj = ok.nonzero(as_tuple=True)
            out_i.append(own[b, li])
            out_j.append(cand[b, lj])
    return torch.cat(out_i), torch.cat(out_j)


def work_counts(x: torch.Tensor, prd: torch.Tensor, cutoff: float,
                triplets: bool = False) -> dict:
    """What the kernels' work is counted per (`roofline/peaks`): `pairs`,
    the unordered pairs closer than `cutoff`, each once; `atoms`; and with
    `triplets`, the ordered triplets (i; j, k), j != k, with r_ij and r_ik
    both under `cutoff`: sum over atoms of n_i (n_i - 1), n_i the atom's
    pairs."""
    i, j = half_pairs(x, prd, cutoff)
    out = {"pairs": int(i.numel()), "atoms": int(x.shape[0])}
    if triplets:
        n = torch.bincount(torch.cat([i, j]), minlength=x.shape[0])
        out["triplets"] = int((n * (n - 1)).sum())
    return out
