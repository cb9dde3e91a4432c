"""Planted inputs for the checks of the cell kernels' cutoff decisions.

A pair at the cutoff across a wrapped face is decided in whichever frame
a kernel forms its displacement in, and rounded frames disagree there by
an ulp (ROADMAP F12). For an axis with box length L, the pair is row i at
b in the first cell along that axis and row j at xj in the last, both at
the middle of the grid in the other two axes, so only that axis
separates them. The frames, each as the kernels round it:

  "half"       the Newton-half K1/K2 (and, since the port takes its
               frame, lj_cell_force): d = xj - (b + L), once for the pair;
  "candidate"  the full stencil with the candidate shifted (K7, P6):
               row i forms b - (xj - L), row j xj - (b + L);
  "image"      the JAX package's XLA path (ops/gridforce, minimum image):
               d = (xj - b) - L.

`pair_offset` draws b from a seed until the candidate frame decides row i
apart from the half frame in some case while the image frame agrees with
it in every case, so that one input shows the repair and keeps the JAX
package's two paths in step. The cases put xj at X0 = (b + L) - rc, where
r2 in the half frame is rc * rc (the cutoff where rc * rc == cutsq), and
one ulp either side.

`lattice_grid` fills a cell-major grid of any shape with jittered atoms
at random lanes among pad rows (grids of 1 and 2 cells per dim, cells
that need two row passes).

Used by tests/test_torch_cutoff_frame.py, the CUDA tests and
chip_smoke.py. numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sortedforce import _pad_x

CASES = ("outside", "at", "inside")  # xj one ulp out, at X0, one ulp in
SEED = 2024
MAX_DRAWS = 10000


def _np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def case_positions(b, L, rc, dtype) -> dict:
    """{case: xj}: X0 = (b + L) - rc and one ulp either side, rounded in
    `dtype` (X0 - rc is exact: both lie in L's binade or the one below)."""
    t = _np(dtype)
    x0 = t(t(t(b) + t(L)) - t(rc))
    return {"outside": t(x0 - np.spacing(x0)), "at": x0,
            "inside": t(x0 + np.spacing(x0))}


def frame_decisions(b, xj, L, cutsq, dtype) -> dict:
    """{frame: (row i takes the pair, row j takes it)}, each operation
    rounded in `dtype` as the kernels round it."""
    t = _np(dtype)
    b, xj, L, cutsq = t(b), t(xj), t(L), t(cutsq)

    def take(d):
        return bool(t(d * d) < cutsq)

    half = take(t(xj - t(b + L)))
    image = take(t(t(xj - b) - L))
    return {"half": (half, half), "image": (image, image),
            "candidate": (take(t(b - t(xj - L))), half)}


def pair_offset(L, cutsq, dtype, seed: int = SEED) -> float:
    """b for an axis of length L: drawn from `seed` in [0.2, 0.6) until
    the candidate frame takes a row-i decision the half frame does not, in
    some case, and the image frame agrees with the half frame in all."""
    rc = float(np.sqrt(cutsq))
    rng = np.random.default_rng(seed)
    for _ in range(MAX_DRAWS):
        b = _np(dtype)(rng.uniform(0.2, 0.6))
        dec = [frame_decisions(b, xj, L, cutsq, dtype)
               for xj in case_positions(b, L, rc, dtype).values()]
        if (any(d["candidate"] != d["half"] for d in dec)
                and all(d["image"] == d["half"] for d in dec)):
            return float(b)
    raise RuntimeError(f"no planted pair found in {MAX_DRAWS} draws")


def planted_rows(ncells, cc) -> list:
    """[(row i, row j)] per axis: lane 0 of the first and of the last cell
    along the axis, the middle cell (n // 2) in the other two."""
    nx, ny, nz = ncells
    mid = [n // 2 for n in ncells]
    rows = []
    for axis, n in enumerate(ncells):
        ci, cj = list(mid), list(mid)
        ci[axis], cj[axis] = 0, n - 1
        rows.append(tuple(((c[0] * ny + c[1]) * nz + c[2]) * cc
                          for c in (ci, cj)))
    return rows


def wrapped_pairs(ncells, cc, prd, cutsq, dtype, case: str,
                  device="cpu") -> tuple:
    """A cell-major grid [3, nx*ny*nz, cc] of pad sentinels (as
    ops/sortedforce pads them) with one pair planted across each periodic
    face (`planted_rows`), xj in the given case; the float ids [nx*ny*nz,
    cc] (the row index, -1 for a pad); the rows; and {axis: (row i's
    decision, row j's decision)} in each frame. The three pairs are
    further than the cutoff from each other. Needs cells wider than 2.5,
    as the melt's are."""
    if case not in CASES:
        raise ValueError(f"case must be one of {CASES}, got {case!r}")
    if min(ncells) < 3:
        raise ValueError(f"planted pairs need >= 3 cells per dim, got "
                         f"{tuple(ncells)}")
    nx, ny, nz = ncells
    cap = nx * ny * nz * cc
    t = _np(dtype)
    prd = [float(p) for p in prd]
    rc = float(np.sqrt(cutsq))
    x = _pad_x(cap, torch.float64, "cpu").numpy().astype(t)
    planes = np.stack([x, x, x])
    ids = np.full(cap, -1.0, dtype=t)
    rows = planted_rows(ncells, cc)
    decisions = {}
    for axis, (ri, rj) in enumerate(rows):
        L = prd[axis]
        b = t(pair_offset(L, cutsq, dtype))
        xj = case_positions(b, L, rc, dtype)[case]
        for r in (ri, rj):
            for a in range(3):
                planes[a, r] = t((ncells[a] // 2 + 0.5) * prd[a] / ncells[a])
            ids[r] = r
        planes[axis, ri], planes[axis, rj] = b, xj
        decisions[axis] = frame_decisions(b, xj, L, cutsq, dtype)
    tdt = torch.float64 if dtype == torch.float64 else torch.float32
    g = torch.from_numpy(planes).to(device=device, dtype=tdt).reshape(
        3, nx * ny * nz, cc)
    gi = torch.from_numpy(ids).to(device=device, dtype=tdt).reshape(
        nx * ny * nz, cc)
    return g, gi, rows, decisions


def taken(force, rows) -> dict:
    """{axis: (row i's force along the axis != 0, row j's)}: the decisions a
    force pass took on `wrapped_pairs`' rows (no other pair reaches them).
    `force`: [3, ...] flattening to [3, rows]."""
    f = force.reshape(3, -1)
    return {axis: tuple(bool(f[axis, r] != 0) for r in pair)
            for axis, pair in enumerate(rows)}


def lattice_grid(ncells, cc, counts, seed, dtype, device, side=3.0):
    """A cell-major grid of `ncells` cells of edge `side` and `cc` rows:
    cell c holds counts[c] atoms on a jittered sub-lattice inside the cell
    (no two closer than about 0.5), at lanes drawn at random, so pads (the
    layout's sentinels) are interleaved with live rows. Returns (g [3,
    ncell, cc], prd, valid [ncell, cc])."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = ncells
    ncell = nx * ny * nz
    g = _pad_x(ncell * cc, torch.float64, "cpu").numpy()
    g = np.repeat(g[None], 3, axis=0).reshape(3, ncell, cc)
    valid = np.zeros((ncell, cc), dtype=bool)
    for c in range(ncell):
        cx, cy, cz = c // (ny * nz), (c // nz) % ny, c % nz
        m = int(np.ceil(counts[c] ** (1 / 3) - 1e-9))
        sub = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                       -1).reshape(-1, 3)[:counts[c]]
        pos = (np.array([cx, cy, cz]) + (sub + 0.5) / m) * side
        pos += rng.uniform(-0.05, 0.05, pos.shape)
        lanes = rng.choice(cc, counts[c], replace=False)
        g[:, c, lanes] = pos.T
        valid[c, lanes] = True
    prd = torch.tensor([nx * side, ny * side, nz * side], dtype=dtype)
    return (torch.from_numpy(g).to(dtype).to(device), prd.to(device),
            torch.from_numpy(valid).to(device))
