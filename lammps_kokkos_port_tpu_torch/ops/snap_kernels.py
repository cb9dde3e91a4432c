"""SNAP (one element) and ZBL on the sorted layout: CUDA for Hopper, plus
the plain twins.

No Pallas kernel is replaced: the JAX package takes SNAP's forces as
jax.grad of the energy over its neighbour matrix. The port computes them
as Kokkos's SNAP does (src/KOKKOS/pair_snap_kokkos_impl.h: compute_ui,
compute_yi, compute_fused_deidrj), in the kernels of `csrc/snap.cu`, over
the short list of `tersoff_kernels.short_lists` (each row's neighbours
within a cutoff; an overflow grows the list through the grow-retry):

  `snap_ui` (`snap_ui_kernel`): each valid row's U = wself I + sum over its
      list within rcut of sfac(r) wj u(r), the Wigner U of j <= twojmax by
      the VMK 4.8.2 recursion with LAMMPS's fill of the right half, kept
      on the half (models/pair_snap.half_index): [rows, nhalf, 2];
  `snap_yi` (`snap_yi_kernel`): Y = dE/dU on the half from U, by the
      style's Y table (models/pair_snap.y_table): [rows, nhalf, 2];
  `snap_deidrj` (`snap_deidrj_kernel`): for each pair (i, j) of the list
      within rcut, dE_i/dr_ij = sum over the half of Re[conj(Y_i) dU/dr]
      (U and dU/dr again by the recursion), added to f_i, taken from f_j;
  `snap_yi_tally`, `snap_deidrj_tally` (`..._tally_kernel`): the same two
      passes for thermo rows, which also write each row's energy E_i =
      E_0 + 1/3 sum Re[conj(Y) U] (every term of B is trilinear in U) into
      plane 0 of a [7, rows] tally, and each pair's virial -d (x) dE/dr
      into planes 1-6 of row i, summed over the valid rows in float64
      (`pair_kernels.tally_sums`);
  `zbl_pair` (`zbl_pair_kernel`, its tally instance `zbl_pair_tally`):
      pair_style zbl over the same list, each valid row's ordered pairs
      within the outer cutoff, the force onto its own row (the reverse
      pair gives the other's), with the energy and virial halved per
      ordered pair on thermo rows.

`compute` is pair_style snap's force path, `compute_zbl` zbl's; each
builds its own short list at its cutoff. Under `pair_style hybrid/overlay`
(models/forcefield.HybridOverlay) one list at the overlay's cutoff serves
both (`snap_terms`, `zbl_terms`). Spans: `pair.snap` > `pair.snap.short`,
`pair.snap.ui`, `pair.snap.yi`, `pair.snap.deidrj`; `pair.zbl` >
`pair.zbl.short` (where ZBL builds the list); the counter
`pair.snap_tally_rows`, one a SNAP energy/virial pass.

CPU tensors go to the plain PyTorch twins (`*_reference`: the kernels'
arithmetic, vectorised over pairs); CUDA tensors go to the kernels, built
with nvcc at first use (ops/cuda_build), or raise. Every launch adds one
to its counter (`snap_ui.launches`, ...).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import trace
from . import cuda_build
from .pair_kernels import VIRIAL_AXES, tally_sums
from .tersoff_kernels import short_lists

SOURCE = cuda_build.CSRC / "snap.cu"
NSNAP = 9   # models/pair_snap.PairSNAP.kernel_params
NZBL = 12   # models/pair_zbl.PairZBL.kernel_params
MAX_TWOJMAX = 8  # csrc/snap.cu kJMax

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_DBL = ctypes.POINTER(ctypes.c_double)
ARGTYPES = {
    "snap_ui": [_PTR] * 6 + [_I32] * 2 + [_DBL, _PTR],
    "snap_yi": [_PTR] * 6 + [_I32] * 2 + [_DBL, _PTR],
    "snap_deidrj": [_PTR] * 8 + [_I32] * 2 + [_DBL, _PTR],
    "zbl_pair": [_PTR] * 7 + [_I32] * 2 + [_DBL, _PTR],
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


def _check_cuda(*ts):
    x = ts[0]
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {x.dtype}")
    if not all(t.is_contiguous() and t.device == x.device for t in ts):
        raise ValueError("kernel inputs must be contiguous, on one device")


def _check_lists(x, mask, short, nshort, prd):
    rows = x.shape[0]
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be [rows, 3], got {tuple(x.shape)}")
    if mask.dtype != torch.int32 or mask.shape != (rows,):
        raise ValueError("mask must be int32 [rows]")
    if (short.dtype != torch.int32 or short.ndim != 2
            or short.shape[0] != rows or nshort.dtype != torch.int32
            or nshort.shape != (rows,)):
        raise ValueError("short must be int32 [rows, S], nshort int32 [rows]")
    if prd.shape != (3,) or prd.dtype != x.dtype:
        raise ValueError("prd must be a [3] tensor of x's dtype")


def _check_snap(par, nhalf=None):
    if len(par) != NSNAP:
        raise ValueError(f"the SNAP kernels take {NSNAP} parameters")
    twojmax = int(par[0])
    if twojmax > MAX_TWOJMAX:
        raise NotImplementedError(f"the SNAP kernels hold twojmax <= "
                                  f"{MAX_TWOJMAX}, got {twojmax}")
    if nhalf is not None and nhalf != half_count(twojmax):
        raise ValueError(f"{nhalf} half entries: twojmax {twojmax} has "
                         f"{half_count(twojmax)}")


def half_count(twojmax: int) -> int:
    """Entries of the half of U_0..U_twojmax (rows mb <= j/2)."""
    return sum((j // 2 + 1) * (j + 1) for j in range(twojmax + 1))


# ---- plain twins ----------------------------------------------------------

def _min_image(d, prd):
    return d - prd * torch.round(d / prd)


def _pairs(x, short, nshort, prd, cutsq):
    """The list's pairs (i, j) with 1e-20 < r^2 < cutsq, in list order:
    (pi, pj, d = x_j - x_i, r^2)."""
    S = short.shape[1]
    slot = torch.arange(S, device=x.device)
    pi, pjj = (slot[None, :] < nshort[:, None].long()).nonzero(as_tuple=True)
    pj = short[pi, pjj].long()
    d = _min_image(x[pj] - x[pi], prd)
    rsq = (d * d).sum(-1)
    ok = (rsq < cutsq) & (rsq > 1e-20)
    return pi[ok], pj[ok], d[ok], rsq[ok]


def _cayley_klein(par, d, rsq):
    """r, the Cayley-Klein a, b, z0 and the switch (sfac wj, dsfac wj) of
    each pair (compute_ui and compute_duidrj's geometry)."""
    _, _, rcut, rfac0, rmin0, wj, _, switchflag, _ = par
    r = torch.sqrt(rsq)
    rscale0 = rfac0 * math.pi / (rcut - rmin0)
    theta0 = (r - rmin0) * rscale0
    z0 = r * torch.cos(theta0) / torch.sin(theta0)
    r0inv = 1.0 / torch.sqrt(rsq + z0 * z0)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    a = torch.complex(r0inv * z0, -r0inv * z)
    b = torch.complex(r0inv * y, -r0inv * x)
    if switchflag:
        arg = (r - rmin0) * (math.pi / (rcut - rmin0))
        inner = r <= rmin0
        sfac = torch.where(inner, 1.0, 0.5 * (torch.cos(arg) + 1.0))
        dsfac = torch.where(inner, 0.0,
                            -0.5 * torch.sin(arg) * (math.pi / (rcut - rmin0)))
    else:
        sfac = torch.ones_like(r)
        dsfac = torch.zeros_like(r)
    return r, a, b, z0, rscale0, r0inv, sfac * wj, dsfac * wj


def _rootpq(twojmax, dtype, dev):
    p = torch.arange(twojmax + 1, dtype=dtype, device=dev)
    q = torch.where(p > 0, p, 1.0)
    return torch.where(p[None, :] > 0, torch.sqrt(p[:, None] / q[None, :]),
                       0.0)


def _mirror_row(h, j, r):
    """Row r > j/2 of U_j [..., j+1] from its half h [..., j//2+1, j+1]:
    U[r][ma] = (-1)^(ma+r) conj(U[j-r][j-ma])."""
    ma = torch.arange(j + 1, device=h.device)
    sign = torch.where((ma + r) % 2 == 1, -1.0, 1.0).to(h.real.dtype)
    return sign * h[..., j - r, :].flip(-1).conj()


def _middle_fix(h, j):
    """LAMMPS's copy on the middle row (mb = j/2, j even) of the half h
    [..., j//2+1, j+1]: its right part the mirror of its left, its middle
    entry conjugated."""
    mb = j // 2
    ma = torch.arange(mb, j + 1, device=h.device)
    sign = torch.where((ma + mb) % 2 == 1, -1.0, 1.0).to(h.real.dtype)
    h[..., mb, mb:] = sign * h[..., mb, j - ma].conj()


def _levels(a, b, twojmax, rootpq, da=None, db=None):
    """The half (rows mb <= j/2) of the Wigner U_j, j = 0..twojmax, of each
    pair by the recursion (compute_uarray: the rows mb <= j/2 from U_{j-1},
    the row j/2 of U_{j-1} through the symmetry, the middle row as LAMMPS's
    copy leaves it), [P, j//2+1, j+1] complex; with da, db [P, 3] also the
    half of dU_j/dr [P, 3, j//2+1, j+1] (compute_duarray, before the
    switch)."""
    P = a.shape[0]
    dev = a.device
    ca, cb = a.conj()[:, None, None], b.conj()[:, None, None]
    u = [torch.ones((P, 1, 1), dtype=a.dtype, device=dev)]
    du = None if da is None else [torch.zeros((P, 3, 1, 1), dtype=a.dtype,
                                              device=dev)]
    for j in range(1, twojmax + 1):
        nmb = j // 2 + 1
        ma = torch.arange(j, device=dev)
        mb = torch.arange(nmb, device=dev)[:, None]
        c1 = rootpq[j - ma[None, :], j - mb]              # [nmb, j]
        c2 = rootpq[ma[None, :] + 1, j - mb]
        prev = u[-1]
        if prev.shape[-2] < nmb:                          # j even
            prev = torch.cat([prev, _mirror_row(prev, j - 1, nmb - 1)[
                ..., None, :]], -2)
        cur = torch.zeros((P, nmb, j + 1), dtype=a.dtype, device=dev)
        cur[..., :j] += c1 * (ca * prev)
        cur[..., 1:] -= c2 * (cb * prev)
        if j % 2 == 0:
            _middle_fix(cur, j)
        u.append(cur)
        if du is None:
            continue
        dprev = du[-1]
        if dprev.shape[-2] < nmb:
            dprev = torch.cat([dprev, _mirror_row(dprev, j - 1, nmb - 1)[
                ..., None, :]], -2)
        t1 = (da.conj()[:, :, None, None] * prev[:, None]
              + ca[:, None] * dprev)
        t2 = (db.conj()[:, :, None, None] * prev[:, None]
              + cb[:, None] * dprev)
        dcur = torch.zeros((P, 3, nmb, j + 1), dtype=a.dtype, device=dev)
        dcur[..., :j] += c1 * t1
        dcur[..., 1:] -= c2 * t2
        if j % 2 == 0:
            _middle_fix(dcur, j)
        du.append(dcur)
    return u, du


def _half(levels, twojmax):
    """The halves of the levels, [..., j//2+1, j+1] each, concatenated on
    the last dim: [..., nhalf]."""
    return torch.cat([lv.reshape(*lv.shape[:-2], -1) for lv in levels], -1)


def _full_from_half(uh, twojmax):
    """The full U [..., nfull] from its half by the mirror symmetry."""
    parts, pos = [], 0
    for j in range(twojmax + 1):
        n = (j // 2 + 1) * (j + 1)
        h = uh[..., pos:pos + n].reshape(*uh.shape[:-1], j // 2 + 1, j + 1)
        pos += n
        full = torch.zeros((*uh.shape[:-1], j + 1, j + 1), dtype=uh.dtype,
                           device=uh.device)
        full[..., :j // 2 + 1, :] = h
        ma = torch.arange(j + 1, device=uh.device)
        for mb in range(j // 2 + 1, j + 1):
            src = j - mb
            sign = torch.where((ma + src) % 2 == 1, -1.0, 1.0).to(
                uh.real.dtype)
            full[..., mb, :] = (sign * h[..., src, :].conj()).flip(-1)
        parts.append(full.reshape(*uh.shape[:-1], -1))
    return torch.cat(parts, -1)


def _as_complex(t):
    return torch.view_as_complex(t.contiguous())


def snap_ui_reference(par, x, mask, short, nshort, prd):
    """U on the half, [rows, nhalf, 2] (re, im), as `snap_ui_kernel` forms
    it: the self term wself on the diagonal of each valid row, plus sfac wj
    u of each pair of its list within rcut. Rows with mask 0 hold 0."""
    twojmax = int(par[0])
    rows = x.shape[0]
    pi, _, d, rsq = _pairs(x, short, nshort, prd, par[1])
    pi = pi[mask[pi] != 0]  # the short list holds valid rows only
    _, a, b, _, _, _, sw, _ = _cayley_klein(par, d, rsq)
    rp = _rootpq(twojmax, x.dtype, x.device)
    u, _ = _levels(a, b, twojmax, rp)
    uh = _half(u, twojmax) * sw[:, None]
    nh = uh.shape[1]
    out = torch.zeros((rows, nh), dtype=uh.dtype, device=x.device)
    out.index_add_(0, pi, uh)
    selfh = _half([torch.eye(j + 1, dtype=uh.dtype, device=x.device)[
        :j // 2 + 1] for j in range(twojmax + 1)], twojmax) * par[6]
    out += torch.where(mask[:, None] != 0, selfh[None, :], 0.0)
    return torch.view_as_real(out).contiguous()


def y_terms(entries, coef, dtype, dev):
    """The unpacked Y table as tensors: (a, b, conj_a, conj_b, out, coef)."""
    e = torch.as_tensor(entries, dtype=torch.int64, device=dev)
    mask9 = (1 << 9) - 1
    return (e & mask9, (e >> 9) & mask9, ((e >> 18) & 1).bool(),
            ((e >> 19) & 1).bool(), e >> 20,
            torch.as_tensor(coef, dtype=dtype, device=dev))


def snap_yi_reference(par, table, mask, ulist, tally=False, block=128):
    """Y on the half, [rows, nhalf, 2], from U (`snap_ui`'s) by the Y table
    (models/pair_snap.y_table: entries, coef); with `tally` also each valid
    row's energy [rows], E_0 + 1/3 sum Re[conj(Y) U] (E_0 = par[8]). Rows
    with mask 0 hold 0. Rows go `block` at a time."""
    twojmax = int(par[0])
    rows, nh, _ = ulist.shape
    dev = ulist.device
    a, b, conj_a, conj_b, out_h, coef = y_terms(*table, ulist.dtype, dev)
    groups = []
    for fa in (False, True):
        for fb in (False, True):
            g = (conj_a == fa) & (conj_b == fb)
            groups.append((fa, fb, a[g], b[g], out_h[g], coef[g]))
    uh = _as_complex(ulist)
    y = torch.zeros((rows, nh), dtype=uh.dtype, device=dev)
    valid = torch.nonzero(mask != 0).flatten()
    for s in range(0, valid.numel(), block):
        r = valid[s:s + block]
        full = _full_from_half(uh[r], twojmax).t().contiguous()  # [nfull, R]
        both = (full, full.conj())
        yt = torch.zeros((nh, r.numel()), dtype=uh.dtype, device=dev)
        for fa, fb, ga, gb, gout, gcoef in groups:
            yt.index_add_(0, gout, gcoef[:, None] * both[fa][ga]
                          * both[fb][gb])
        y[r] = yt.t()
    yt = torch.view_as_real(y).contiguous()
    if not tally:
        return yt
    e = (y.conj() * uh).real.sum(1) / 3.0 + par[8]
    return yt, torch.where(mask != 0, e, 0.0)


def snap_deidrj_reference(par, x, mask, short, nshort, prd, ylist,
                          tally=False):
    """Forces [rows, 3] from Y: for each pair (i, j) of the lists within
    rcut, dedr = sum over the half of Re[conj(Y_i) dU_ij/dr] (dU: the
    switch's derivative times u r_hat, plus sfac wj times the recursion's
    dU), onto f_i, and minus onto f_j; with `tally` also the virial [6,
    rows], each pair's -d (x) dedr (xx, yy, zz, xy, xz, yz) in row i."""
    twojmax = int(par[0])
    rows = x.shape[0]
    pi, pj, d, rsq = _pairs(x, short, nshort, prd, par[1])
    keep = mask[pi] != 0
    pi, pj, d, rsq = pi[keep], pj[keep], d[keep], rsq[keep]
    r, a, b, z0, rscale0, r0inv, sw, dsw = _cayley_klein(par, d, rsq)
    # compute_duidrj / compute_duarray's derivatives of a and b
    dz0dr = z0 / r - (r * rscale0) * (rsq + z0 * z0) / rsq
    uhat = d / r[:, None]
    dr0invdr = -r0inv ** 3 * (r + z0 * dz0dr)
    dr0inv = dr0invdr[:, None] * uhat
    dz0 = dz0dr[:, None] * uhat
    zc = d[:, 2:3]
    da_r = dz0 * r0inv[:, None] + z0[:, None] * dr0inv
    da_i = -zc * dr0inv
    da_i = da_i - torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype,
                               device=d.device) * r0inv[:, None]
    db_r = d[:, 1:2] * dr0inv
    db_i = -d[:, 0:1] * dr0inv
    db_i = db_i - torch.tensor([1.0, 0.0, 0.0], dtype=d.dtype,
                               device=d.device) * r0inv[:, None]
    db_r = db_r + torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype,
                               device=d.device) * r0inv[:, None]
    da = torch.complex(da_r, da_i)
    db = torch.complex(db_r, db_i)
    rp = _rootpq(twojmax, x.dtype, x.device)
    u, du = _levels(a, b, twojmax, rp, da, db)
    # sum over the half of Re[conj(Y) (dsfac u r_hat + sfac du)]
    y = ylist[pi]                                         # [P, nh, 2]
    yu = torch.einsum("phc,phc->p", y, torch.view_as_real(_half(u, twojmax)))
    ydu = torch.einsum("phc,pkhc->pk", y,
                       torch.view_as_real(_half(du, twojmax)))
    dedr = dsw[:, None] * yu[:, None] * uhat + sw[:, None] * ydu  # [P, 3]
    f = torch.zeros_like(x)
    f.index_add_(0, pi, dedr)
    f.index_add_(0, pj, -dedr)
    if not tally:
        return f
    vir = torch.zeros((6, rows), dtype=x.dtype, device=x.device)
    for k, (p, q) in enumerate(VIRIAL_AXES):
        vir[k].index_add_(0, pi, -d[:, p] * dedr[:, q])
    return f, vir


def zbl_pair_reference(par, x, mask, short, nshort, prd, tally=False):
    """ZBL forces [rows, 3] over the lists (each ordered pair within the
    outer cutoff onto its own row); with `tally` also the [7, rows] tally
    (half of each ordered pair's energy and virial in its row).
    par: models/pair_zbl.PairZBL.kernel_params()."""
    (cut_inner, cutsq, d1a, d2a, d3a, d4a, zze, sw1, sw2, sw3, sw4,
     sw5) = par
    pi, _, d, rsq = _pairs(x, short, nshort, prd, cutsq)
    keep = mask[pi] != 0
    pi, d, rsq = pi[keep], d[keep], rsq[keep]
    r = torch.sqrt(rsq)
    rinv = 1.0 / r
    e1, e2, e3, e4 = (torch.exp(-c * r) for c in (d1a, d2a, d3a, d4a))
    cs = ZBL_CS
    s = cs[0] * e1 + cs[1] * e2 + cs[2] * e3 + cs[3] * e4
    sp = -(cs[0] * d1a * e1 + cs[1] * d2a * e2 + cs[2] * d3a * e3
           + cs[3] * d4a * e4)
    dedr = zze * (sp - s * rinv) * rinv
    t = r - cut_inner
    outer = rsq > cut_inner * cut_inner
    dedr = dedr + torch.where(outer, t * t * (sw1 + sw2 * t), 0.0)
    fpair = -dedr * rinv
    f = torch.zeros_like(x)
    # LAMMPS's delx = x_i - x_j = -d: f_i += delx fpair
    f.index_add_(0, pi, -d * fpair[:, None])
    if not tally:
        return f
    e = zze * s * rinv + sw5 + torch.where(outer, t * t * t * (sw3 + sw4 * t),
                                           0.0)
    out = torch.zeros((7, x.shape[0]), dtype=x.dtype, device=x.device)
    out[0].index_add_(0, pi, 0.5 * e)
    for k, (p, q) in enumerate(VIRIAL_AXES):
        out[k + 1].index_add_(0, pi, 0.5 * d[:, p] * d[:, q] * fpair)
    return f, out


# the ZBL screening function's coefficients (src/pair_zbl_const.h)
ZBL_CS = (0.02817, 0.28022, 0.50986, 0.18175)


# ---- wrappers -------------------------------------------------------------

def snap_ui(par, x, mask, short, nshort, prd):
    """U of every valid row on the half, [rows, nhalf, 2] (rows with mask 0
    are not written on the card). On a CUDA tensor it launches
    `snap_ui_kernel`, adding one to `snap_ui.launches`."""
    _check_lists(x, mask, short, nshort, prd)
    _check_snap(par)
    if x.device.type == "cpu":
        return snap_ui_reference(par, x, mask, short, nshort, prd)
    _check_cuda(x, mask, short, nshort, prd)
    rows, S = short.shape
    ulist = torch.empty((rows, half_count(int(par[0])), 2), dtype=x.dtype,
                        device=x.device)
    arr = (ctypes.c_double * NSNAP)(*par)
    with torch.cuda.device(x.device):
        err = _fn("snap_ui", x.dtype)(
            x.data_ptr(), mask.data_ptr(), prd.data_ptr(), short.data_ptr(),
            nshort.data_ptr(), ulist.data_ptr(), rows, S, arr, _stream(x))
    if err != 0:
        raise RuntimeError(f"snap_ui launch failed: CUDA error {err}")
    snap_ui.launches += 1
    return ulist


def _yi_launch(par, table_dev, mask, ulist, energy):
    _check_cuda(ulist, mask, *table_dev)
    entries, coef = table_dev
    if coef.dtype != ulist.dtype or entries.dtype != torch.int32:
        raise ValueError("the table is int32 entries and coefficients of "
                         "U's dtype")
    rows = ulist.shape[0]
    ylist = torch.empty_like(ulist)
    arr = (ctypes.c_double * NSNAP)(*par)
    stem, counted = "snap_yi", snap_yi
    eptr = 0
    if energy is not None:
        eptr = energy.data_ptr()
        counted = snap_yi_tally
    with torch.cuda.device(ulist.device):
        err = _fn(stem, ulist.dtype)(
            mask.data_ptr(), ulist.data_ptr(), entries.data_ptr(),
            coef.data_ptr(), ylist.data_ptr(), eptr or None, rows,
            entries.numel(), arr, _stream(ulist))
    if err != 0:
        raise RuntimeError(f"{stem} launch failed: CUDA error {err}")
    counted.launches += 1
    return ylist


def snap_yi(par, table, mask, ulist):
    """Y = dE/dU of every valid row on the half, [rows, nhalf, 2], from
    `snap_ui`'s U. table: (entries, coef) of models/pair_snap.y_table, as
    tensors on U's device (coef of U's dtype) on a CUDA tensor. On a CUDA
    tensor it launches `snap_yi_kernel`, adding one to
    `snap_yi.launches`."""
    _check_snap(par, ulist.shape[1])
    if ulist.device.type == "cpu":
        return snap_yi_reference(par, table, mask, ulist)
    return _yi_launch(par, table, mask, ulist, None)


def snap_yi_tally(par, table, mask, ulist, energy):
    """As `snap_yi`, and each valid row's energy written into `energy`
    [rows] of U's dtype (thermo rows). On a CUDA tensor it launches
    `snap_yi_tally_kernel`, adding one to `snap_yi_tally.launches`."""
    _check_snap(par, ulist.shape[1])
    if energy.shape != (ulist.shape[0],) or not energy.is_contiguous():
        raise ValueError("energy must be a contiguous [rows] tensor")
    if ulist.device.type == "cpu":
        y, e = snap_yi_reference(par, table, mask, ulist, tally=True)
        energy.copy_(e)
        return y
    return _yi_launch(par, table, mask, ulist, energy)


def _deidrj_launch(par, x, mask, short, nshort, prd, ylist, vir):
    _check_cuda(x, mask, short, nshort, prd, ylist)
    rows, S = short.shape
    f = torch.zeros_like(x)
    arr = (ctypes.c_double * NSNAP)(*par)
    stem, counted, vptr = "snap_deidrj", snap_deidrj, None
    if vir is not None:
        counted, vptr = snap_deidrj_tally, vir.data_ptr()
    with torch.cuda.device(x.device):
        err = _fn(stem, x.dtype)(
            x.data_ptr(), mask.data_ptr(), prd.data_ptr(), short.data_ptr(),
            nshort.data_ptr(), ylist.data_ptr(), f.data_ptr(), vptr, rows, S,
            arr, _stream(x))
    if err != 0:
        raise RuntimeError(f"{stem} launch failed: CUDA error {err}")
    counted.launches += 1
    return f


def snap_deidrj(par, x, mask, short, nshort, prd, ylist):
    """SNAP forces [rows, 3] from Y (`snap_yi`'s) over the short lists. On
    a CUDA tensor it launches `snap_deidrj_kernel`, adding one to
    `snap_deidrj.launches`."""
    _check_lists(x, mask, short, nshort, prd)
    _check_snap(par, ylist.shape[1])
    if x.device.type == "cpu":
        return snap_deidrj_reference(par, x, mask, short, nshort, prd, ylist)
    return _deidrj_launch(par, x, mask, short, nshort, prd, ylist, None)


def snap_deidrj_tally(par, x, mask, short, nshort, prd, ylist, vir):
    """As `snap_deidrj`, and each pair's virial added into `vir` [6, rows]
    (zeroed by the caller) at its row i (thermo rows). On a CUDA tensor it
    launches `snap_deidrj_tally_kernel`, adding one to
    `snap_deidrj_tally.launches`."""
    _check_lists(x, mask, short, nshort, prd)
    _check_snap(par, ylist.shape[1])
    if vir.shape != (6, x.shape[0]) or not vir.is_contiguous():
        raise ValueError("vir must be a contiguous [6, rows] tensor")
    if x.device.type == "cpu":
        f, v = snap_deidrj_reference(par, x, mask, short, nshort, prd, ylist,
                                     tally=True)
        vir.add_(v)
        return f
    return _deidrj_launch(par, x, mask, short, nshort, prd, ylist, vir)


def _zbl_launch(par, x, mask, short, nshort, prd, tally):
    _check_cuda(x, mask, short, nshort, prd)
    if len(par) != NZBL:
        raise ValueError(f"the ZBL kernel takes {NZBL} parameters")
    rows, S = short.shape
    f = torch.zeros_like(x)
    out = None
    stem, counted, tptr = "zbl_pair", zbl_pair, None
    if tally:
        out = torch.zeros((7, rows), dtype=x.dtype, device=x.device)
        counted, tptr = zbl_pair_tally, out.data_ptr()
    arr = (ctypes.c_double * NZBL)(*par)
    with torch.cuda.device(x.device):
        err = _fn(stem, x.dtype)(
            x.data_ptr(), mask.data_ptr(), prd.data_ptr(), short.data_ptr(),
            nshort.data_ptr(), f.data_ptr(), tptr, rows, S, arr, _stream(x))
    if err != 0:
        raise RuntimeError(f"{stem} launch failed: CUDA error {err}")
    counted.launches += 1
    return f, out


def zbl_pair(par, x, mask, short, nshort, prd):
    """ZBL forces [rows, 3] over the short lists. On a CUDA tensor it
    launches `zbl_pair_kernel`, adding one to `zbl_pair.launches`."""
    _check_lists(x, mask, short, nshort, prd)
    if x.device.type == "cpu":
        return zbl_pair_reference(par, x, mask, short, nshort, prd)
    return _zbl_launch(par, x, mask, short, nshort, prd, False)[0]


def zbl_pair_tally(par, x, mask, short, nshort, prd):
    """ZBL forces and the [7, rows] tally (pe, xx, yy, zz, xy, xz, yz by
    row). On a CUDA tensor it launches `zbl_pair_tally_kernel`, adding one
    to `zbl_pair_tally.launches`."""
    _check_lists(x, mask, short, nshort, prd)
    if x.device.type == "cpu":
        return zbl_pair_reference(par, x, mask, short, nshort, prd, True)
    return _zbl_launch(par, x, mask, short, nshort, prd, True)


for _k in (snap_ui, snap_yi, snap_yi_tally, snap_deidrj, snap_deidrj_tally,
           zbl_pair, zbl_pair_tally):
    _k.launches = 0


# ---- the styles' force paths ----------------------------------------------

def _device_table(style, dtype, device):
    """The style's Y table as tensors on `device` (cached on the style)."""
    key = (dtype, str(device))
    cache = style.__dict__.setdefault("_device_tables", {})
    if key not in cache:
        entries, coef = style.table
        cache[key] = (torch.as_tensor(entries, device=device),
                      torch.as_tensor(coef, dtype=dtype, device=device))
    return cache[key]


def snap_terms(style, state, cl, eflag, vflag, lists):
    """(f, pe, virial) of SNAP on given short lists (a superset within its
    cutoff is fine: the kernels test rcut)."""
    x, prd, short, nshort = lists
    par = style.kernel_params()
    mask = state.mask
    table = (style.table if x.device.type == "cpu"
             else _device_table(style, x.dtype, x.device))
    with trace.span("pair.snap.ui"):
        ulist = snap_ui(par, x, mask, short, nshort, prd)
    if not eflag and not vflag:
        with trace.span("pair.snap.yi"):
            ylist = snap_yi(par, table, mask, ulist)
        with trace.span("pair.snap.deidrj"):
            return (snap_deidrj(par, x, mask, short, nshort, prd, ylist),
                    None, None)
    trace.count("pair.snap_tally_rows")
    tally = torch.zeros((7, x.shape[0]), dtype=x.dtype, device=x.device)
    with trace.span("pair.snap.yi"):
        ylist = snap_yi_tally(par, table, mask, ulist, tally[0])
    with trace.span("pair.snap.deidrj"):
        f = snap_deidrj_tally(par, x, mask, short, nshort, prd, ylist,
                              tally[1:])
    sums = tally_sums(tally, state.valid_mask).to(state.dtype)
    return f, sums[0] if eflag else None, sums[1:] if vflag else None


def zbl_terms(style, state, cl, eflag, vflag, lists):
    """(f, pe, virial) of ZBL on given short lists."""
    x, prd, short, nshort = lists
    par = style.kernel_params()
    if not eflag and not vflag:
        return zbl_pair(par, x, state.mask, short, nshort, prd), None, None
    f, tally = zbl_pair_tally(par, x, state.mask, short, nshort, prd)
    sums = tally_sums(tally, state.valid_mask).to(state.dtype)
    return f, sums[0] if eflag else None, sums[1:] if vflag else None


def compute(style, state, cl, eflag: bool, vflag: bool):
    """pair_style snap alone on a SortedCells state: its short list at
    rcut, then ui, yi and deidrj (their tally instances on an
    energy/virial call)."""
    with trace.span("pair.snap"):
        lists = short_lists(style.max_cutoff(), state, cl, "snap")
        return snap_terms(style, state, cl, eflag, vflag, lists)


def compute_zbl(style, state, cl, eflag: bool, vflag: bool):
    """pair_style zbl alone on a SortedCells state: its short list at the
    outer cutoff, then the pair pass."""
    with trace.span("pair.zbl"):
        lists = short_lists(style.max_cutoff(), state, cl, "zbl")
        return zbl_terms(style, state, cl, eflag, vflag, lists)
