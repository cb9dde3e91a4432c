"""Tersoff (one element) on the sorted layout: CUDA for Hopper, plus the
plain twins.

No Pallas kernel is replaced: the JAX package takes Tersoff's forces as
jax.grad of one energy over its neighbour matrix. The port computes them as
LAMMPS does (src/MANYBODY/pair_tersoff.cpp), in two kernels of
`csrc/tersoff_cell.cu`, in the manner of Kokkos's short-list and force
kernels:

  `tersoff_short` (`tersoff_short_kernel`): each valid row's neighbours
      within R + D on the 27-cell stencil of the sorted layout, in walk
      order, into a [rows, S] table of row indices and a count per row. A
      row with more than S neighbours keeps S, sets the layout's sticky
      overflow flag and raises the list's `short_need` to its count, in
      place: the host grows S (runner._grow_params) and re-runs the segment;
  `tersoff_force` (`tersoff_force_kernel`): one thread per ordered pair
      (i, j) of the short lists: zeta_ij, b_ij and db/dzeta, and the forces
      on i, j and every k near i, landed by atomics in a zeroed [rows, 3]
      output;
  `tersoff_force_tally` (`tersoff_force_tally_kernel`): the same pass for
      thermo rows, which also adds each pair's energy and virial into its
      row i of a [7, rows] tally (pe, xx, yy, zz, xy, xz, yz; LAMMPS's
      ev_tally and v_tally3), summed over the valid rows in float64
      (`pair_kernels.tally_sums`).

`compute` chains them on a SortedCells state, under the spans
`pair.tersoff` > `pair.tersoff.short`, `pair.tersoff.force`, and counts
`pair.tersoff_tally_rows` for each energy/virial pass (utils/trace). The
kernels read the state's [rows, 3] positions and int32 mask as they are.

CPU tensors go to the plain PyTorch twins `tersoff_short_reference` and
`tersoff_force_reference` (the same arithmetic, vectorised over pairs and
neighbour slots); CUDA tensors go to the kernels, built with nvcc at first
use (ops/cuda_build), or raise. Every launch adds one to its counter:
`tersoff_short.launches`, `tersoff_force.launches`,
`tersoff_force_tally.launches`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import trace
from . import cuda_build
from .pair_kernels import stencil, tally_sums

SOURCE = cuda_build.CSRC / "tersoff_cell.cu"
NPAR = 14  # models/pair_tersoff.FIELDS
# the virial's components (xx, yy, zz, xy, xz, yz) as pairs of axes
VIRIAL_AXES = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
# LAMMPS's clip of the exponent of exp((lam3 (r_ij - r_ik))^m)
EX_CLIP = 69.0776

_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_DBL = ctypes.POINTER(ctypes.c_double)
ARGTYPES = {
    "tersoff_short": [_PTR] * 7 + [_I32] * 5 + [_F64, _PTR],
    "tersoff_force": [_PTR] * 5 + [_I32] * 2 + [_DBL, _PTR],
    "tersoff_force_tally": [_PTR] * 6 + [_I32] * 2 + [_DBL, _PTR],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    for stem, types in ARGTYPES.items():
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"{stem}_{dt}")
            fn.argtypes = types
            fn.restype = _I32
    return lib


def _fn(stem: str, dtype):
    return getattr(_library(),
                   f"{stem}_f32" if dtype == torch.float32 else f"{stem}_f64")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(x, mask, prd, ncells=None):
    """x [rows, 3] of f32 or f64, mask int32 [rows], prd [3], one device;
    with ncells, rows a whole number of cells of the grid (>= 3 a dim)."""
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be [rows, 3], got {tuple(x.shape)}")
    if mask is not None and (mask.dtype != torch.int32
                             or mask.shape != (x.shape[0],)
                             or mask.device != x.device):
        raise ValueError("mask must be int32 [rows] on x's device")
    if prd.shape != (3,) or prd.dtype != x.dtype or prd.device != x.device:
        raise ValueError("prd must be a [3] tensor of x's dtype and device")
    if ncells is not None:
        if min(ncells) < 3:
            # the 27-cell stencil would meet a cell twice
            raise ValueError(f"cell grid {tuple(ncells)} needs >= 3 cells "
                             "per dim")
        if x.shape[0] % (ncells[0] * ncells[1] * ncells[2]):
            raise ValueError(f"{x.shape[0]} rows are not whole cells of the "
                             f"grid {tuple(ncells)}")


def _check_cuda(*ts):
    x = ts[0]
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {x.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel inputs must be contiguous")


# ---- plain twins ----------------------------------------------------------

def tersoff_short_reference(cutsq, ncells, x, mask, prd, S):
    """The short list in plain PyTorch: (short [rows, S] int32, nshort
    [rows] int32, counts [rows] int64, before the cut at S). Each valid
    row's valid neighbours with r2 < cutsq on the 27-cell stencil, in the
    kernel's walk order (offset, then slot; r2 rounded as the kernel rounds
    it); slots past a row's count hold 0."""
    nx, ny, nz = ncells
    rows = x.shape[0]
    ntot = nx * ny * nz
    cc = rows // ntot
    dev = x.device
    g = x.t().reshape(3, ntot, cc)
    # int32 row ids and positions: at 1M the [rows, 27 * cc] tables are
    # the twin's memory
    rowid = torch.arange(rows, dtype=torch.int32,
                         device=dev).reshape(ntot, cc)
    valid = (mask != 0).reshape(ntot, cc)
    own_valid = valid.reshape(nx, ny, nz, cc, 1)
    hits, cands = [], []
    for _, r2, pair_ok, (crow, cvalid) in stencil(ncells, g[0], g[1], g[2],
                                                  prd, (rowid, valid)):
        hit = (r2 < cutsq) & own_valid & cvalid[..., None, :]
        if pair_ok is not None:
            hit = hit & pair_ok
        hits.append(hit.reshape(rows, cc))
        cands.append(crow[..., None, :].expand(nx, ny, nz, cc, cc)
                     .reshape(rows, cc))
    hit = torch.cat(hits, 1)
    cand = torch.cat(cands, 1)
    counts = hit.sum(1)
    pos = hit.cumsum(1, dtype=torch.int32) - 1
    keep = hit & (pos < S)
    short = torch.zeros((rows, S), dtype=torch.int32, device=dev)
    owner = torch.arange(rows, device=dev)[:, None].expand_as(hit)
    short[owner[keep], pos[keep].long()] = cand[keep]
    return short, counts.clamp(max=S).to(torch.int32), counts


def _min_image(d, prd):
    return d - prd * torch.round(d / prd)


def _fc(r, bigr, bigd):
    """fc and fc' (ters_fc, ters_fc_d)."""
    arg = (math.pi / 2) * (r - bigr) / bigd
    inside = (r >= bigr - bigd) & (r <= bigr + bigd)
    fc = torch.where(r < bigr - bigd, 1.0,
                     torch.where(inside, 0.5 * (1.0 - torch.sin(arg)), 0.0))
    dfc = torch.where(inside, -(math.pi / 4 / bigd) * torch.cos(arg), 0.0)
    return fc, dfc


def _bij(zeta, beta, n):
    """b(zeta) and db/dzeta with ters_bij's and ters_bij_d's branches."""
    c1 = (2.0 * n * 1.0e-16) ** (-1.0 / n)
    c2 = (2.0 * n * 1.0e-8) ** (-1.0 / n)
    c3, c4 = 1.0 / c2, 1.0 / c1
    inv_2n = 1.0 / (2.0 * n)
    tmp = beta * zeta
    tmp_n = tmp ** n
    b = torch.where(
        tmp > c1, 1.0 / torch.sqrt(tmp), torch.where(
            tmp > c2, (1.0 - tmp ** -n * inv_2n) / torch.sqrt(tmp),
            torch.where(tmp < c4, 1.0, torch.where(
                tmp < c3, 1.0 - tmp_n * inv_2n,
                (1.0 + tmp_n) ** -inv_2n))))
    bd = torch.where(
        tmp > c1, beta * -0.5 * tmp ** -1.5, torch.where(
            tmp > c2, beta * (-0.5 * tmp ** -1.5
                              * (1.0 - (1.0 + inv_2n) * tmp ** -n)),
            torch.where(tmp < c4, 0.0, torch.where(
                tmp < c3, -0.5 * beta * tmp ** (n - 1.0),
                -0.5 * (1.0 + tmp_n) ** (-1.0 - inv_2n) * tmp_n / zeta))))
    return b, bd


def tersoff_force_reference(par, x, short, nshort, prd, tally=False):
    """The force pass in plain PyTorch: f [rows, 3] and, with `tally`, the
    [7, rows] tally (pe, xx, yy, zz, xy, xz, yz by row i), as the kernel
    computes them. par: the 14 numbers of models/pair_tersoff.FIELDS."""
    (m, gamma, lam3, c, d, h, n, beta, lam2, bigb, bigr, bigd, lam1,
     biga) = par
    rows, S = short.shape
    dev = x.device
    cutsq = (bigr + bigd) ** 2
    slot = torch.arange(S, device=dev)
    pi, pjj = (slot[None, :] < nshort[:, None].long()).nonzero(as_tuple=True)
    pj = short[pi, pjj].long()
    d1 = _min_image(x[pj] - x[pi], prd)
    rsq1 = (d1 * d1).sum(-1)
    ok = rsq1 < cutsq
    pi, pjj, pj, d1, rsq1 = pi[ok], pjj[ok], pj[ok], d1[ok], rsq1[ok]
    r1 = torch.sqrt(rsq1)
    fc1, dfc1 = _fc(r1, bigr, bigd)

    erep = torch.exp(-lam1 * r1)
    frep = -biga * erep * (dfc1 - fc1 * lam1) / r1

    # every (pair, k) slot of i's list: [P, S]; slots past i's count are
    # not read (the kernel leaves them unwritten)
    live = slot[None, :] < nshort[pi][:, None].long()
    pk = torch.where(live, short[pi].long(), 0)
    tk = live & (slot[None, :] != pjj[:, None])
    d2 = _min_image(x[pk] - x[pi][:, None, :], prd)
    rsq2 = (d2 * d2).sum(-1)
    tk = tk & (rsq2 < cutsq)
    r2 = torch.sqrt(torch.where(tk, rsq2, 1.0))
    fc2, dfc2 = _fc(r2, bigr, bigd)
    rij_hat = d1 / r1[:, None]
    rik_hat = d2 / r2[..., None]
    cost = (rij_hat[:, None, :] * rik_hat).sum(-1)
    hcth = h - cost
    den = 1.0 / (d * d + hcth * hcth)
    g = gamma * (1.0 + c * c / (d * d) - c * c * den)
    gd = gamma * (-2.0 * c * c * hcth) * den * den
    dr = r1[:, None] - r2
    arg = (lam3 * dr) ** 3 if m == 3.0 else lam3 * dr
    ex = torch.where(arg > EX_CLIP, 1.0e30, torch.where(
        arg < -EX_CLIP, 0.0, torch.exp(arg.clamp(-EX_CLIP, EX_CLIP))))
    exd = 3.0 * lam3 ** 3 * dr * dr * ex if m == 3.0 else lam3 * ex
    zeta = torch.where(tk, fc2 * g * ex, 0.0).sum(1)

    eatt = bigb * torch.exp(-lam2 * r1)
    fa = -eatt * fc1
    fa_d = eatt * (lam2 * fc1 - dfc1)
    bij, bij_d = _bij(zeta, beta, n)
    fforce = 0.5 * bij * fa_d / r1
    pref = (-0.5 * fa * bij_d)[:, None, None]

    dcj = (rik_hat - cost[..., None] * rij_hat[:, None, :]) / r1[:, None,
                                                                 None]
    dck = (rij_hat[:, None, :] - cost[..., None] * rik_hat) / r2[..., None]
    a_fc = (-dfc2 * g * ex)[..., None]
    a_g = (fc2 * gd * ex)[..., None]
    a_ex = (fc2 * g * exd)[..., None]
    on = tk[..., None]
    dri = torch.where(on, pref * (a_fc * rik_hat - a_g * (dcj + dck)
                                  + a_ex * (rik_hat - rij_hat[:, None, :])),
                      0.0)
    drj = torch.where(on, pref * (a_g * dcj + a_ex * rij_hat[:, None, :]),
                      0.0)
    drk = torch.where(on, pref * (-a_fc * rik_hat + a_g * dck
                                  - a_ex * rik_hat), 0.0)

    fi = -d1 * frep[:, None] + d1 * fforce[:, None] + dri.sum(1)
    fj = -d1 * fforce[:, None] + drj.sum(1)
    f = torch.zeros_like(x)
    f.index_add_(0, pi, fi)
    f.index_add_(0, pj, fj)
    f.index_add_(0, pk[tk], drk[tk])
    if not tally:
        return f
    out = torch.zeros((7, rows), dtype=x.dtype, device=dev)
    out[0].index_add_(0, pi, 0.5 * fc1 * biga * erep + 0.5 * bij * fa)
    fpair = 0.5 * frep - fforce
    for a, (u, w) in enumerate(VIRIAL_AXES):
        v = d1[:, u] * d1[:, w] * fpair + (
            d1[:, None, u] * drj[..., w] + d2[..., u] * drk[..., w]).sum(1)
        out[a + 1].index_add_(0, pi, v)
    return f, out


# ---- wrappers -------------------------------------------------------------

def tersoff_short(cutsq, ncells, x, mask, prd, S, overflow, need):
    """The short list of every row within sqrt(cutsq): (short [rows, S]
    int32, nshort [rows] int32).

    ncells: the (nx, ny, nz) grid of the sorted layout (>= 3 a dim); x:
    [rows, 3] positions, rows = nx*ny*nz*cc, cell id (cx*ny+cy)*nz+cz;
    mask: int32 [rows], nonzero on valid rows; prd: [3] box lengths; S: the
    list's width. A row with more than S neighbours sets the 0-d bool
    `overflow` and raises the 0-d int32 `need` to its count, in place. On
    a CUDA tensor it launches `tersoff_short_kernel`, adding one to
    `tersoff_short.launches`.
    """
    _check_rows(x, mask, prd, ncells)
    if x.device.type == "cpu":
        short, nshort, counts = tersoff_short_reference(cutsq, ncells, x,
                                                        mask, prd, S)
        over = torch.where(counts > S, counts, 0).max()
        overflow.logical_or_(over > 0)
        need.copy_(torch.maximum(need, over.to(need.dtype)))
        return short, nshort
    _check_cuda(x, mask, prd)
    if (overflow.dtype != torch.bool or need.dtype != torch.int32
            or overflow.numel() != 1 or need.numel() != 1):
        raise ValueError("overflow must be one bool, need one int32")
    rows = x.shape[0]
    nx, ny, nz = ncells
    short = torch.empty((rows, S), dtype=torch.int32, device=x.device)
    nshort = torch.empty(rows, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn("tersoff_short", x.dtype)(
            x.data_ptr(), mask.data_ptr(), prd.data_ptr(), short.data_ptr(),
            nshort.data_ptr(), need.data_ptr(), overflow.data_ptr(), nx, ny,
            nz, rows // (nx * ny * nz), S, cutsq, _stream(x))
    if err != 0:
        raise RuntimeError(f"tersoff_short launch failed: CUDA error {err}")
    tersoff_short.launches += 1
    return short, nshort


def _force_launch(par, x, short, nshort, prd, tally: bool):
    _check_cuda(x, short, nshort, prd)
    if len(par) != NPAR:
        raise ValueError(f"the kernel takes {NPAR} parameters")
    rows, S = short.shape
    f = torch.zeros_like(x)
    arr = (ctypes.c_double * NPAR)(*par)
    out = None
    ptrs = [f.data_ptr()]
    stem, counted = "tersoff_force", tersoff_force
    if tally:
        out = torch.zeros((7, rows), dtype=x.dtype, device=x.device)
        ptrs.append(out.data_ptr())
        stem, counted = "tersoff_force_tally", tersoff_force_tally
    with torch.cuda.device(x.device):
        err = _fn(stem, x.dtype)(
            x.data_ptr(), short.data_ptr(), nshort.data_ptr(), prd.data_ptr(),
            *ptrs, rows, S, arr, _stream(x))
    if err != 0:
        raise RuntimeError(f"{stem} launch failed: CUDA error {err}")
    counted.launches += 1
    return f, out


def _check_lists(x, short, nshort, prd):
    _check_rows(x, None, prd)
    rows = x.shape[0]
    if (short.dtype != torch.int32 or short.ndim != 2
            or short.shape[0] != rows or nshort.dtype != torch.int32
            or nshort.shape != (rows,)):
        raise ValueError("short must be int32 [rows, S], nshort int32 [rows]")


def tersoff_force(par, x, short, nshort, prd):
    """Tersoff forces [rows, 3] from the short lists.

    par: `PairTersoff.kernel_params()`; short, nshort: `tersoff_short`'s
    lists; x, prd as there. On a CUDA tensor it launches
    `tersoff_force_kernel`, adding one to `tersoff_force.launches`.
    """
    _check_lists(x, short, nshort, prd)
    if x.device.type == "cpu":
        return tersoff_force_reference(par, x, short, nshort, prd)
    return _force_launch(par, x, short, nshort, prd, False)[0]


def tersoff_force_tally(par, x, short, nshort, prd):
    """Tersoff forces and each row's energy and virial (thermo rows).

    As `tersoff_force`; returns (f [rows, 3], tally [7, rows]): tally[0]
    the energy of the pairs (i, j) of row i (half of each pair's
    repulsion, half its attraction), tally[1:] their virial (xx, yy, zz,
    xy, xz, yz). On a CUDA tensor it launches
    `tersoff_force_tally_kernel`, adding one to
    `tersoff_force_tally.launches`.
    """
    _check_lists(x, short, nshort, prd)
    if x.device.type == "cpu":
        return tersoff_force_reference(par, x, short, nshort, prd, True)
    return _force_launch(par, x, short, nshort, prd, True)


tersoff_short.launches = 0
tersoff_force.launches = 0
tersoff_force_tally.launches = 0


def compute(style, state, cl, eflag: bool, vflag: bool):
    """(f, pe, virial) of the three-body style on a SortedCells state: the
    short list, then the force pass, or its tally instance on an
    energy/virial call (pe and virial None where not asked for)."""
    p = cl.params
    prd = state.box.prd.to(state.dtype)
    x = state.x.contiguous()
    par = style.kernel_params()
    with trace.span("pair.tersoff"):
        with trace.span("pair.tersoff.short"):
            short, nshort = tersoff_short(style.max_cutoff() ** 2, p.ncells,
                                          x, state.mask, prd, cl.short_cap,
                                          cl.overflow, cl.short_need)
        with trace.span("pair.tersoff.force"):
            if not eflag and not vflag:
                return tersoff_force(par, x, short, nshort, prd), None, None
            trace.count("pair.tersoff_tally_rows")
            f, tally = tersoff_force_tally(par, x, short, nshort, prd)
    sums = tally_sums(tally, state.valid_mask).to(state.dtype)
    return f, sums[0] if eflag else None, sums[1:] if vflag else None
