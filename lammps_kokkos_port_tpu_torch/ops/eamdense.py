"""Dense EAM path: Chebyshev-resampled tables, no per-pair table lookups.

Port of `lammps_kokkos_port_tpu/ops/eamdense.py`. At setup the spline
tables are resampled into global Chebyshev fits in u = r^2 (no sqrt per
pair):

    g(u)   = rhor(r)                      density contribution
    a(u)   = rhor'(r)/r                   embedding-force factor
    b(u)   = z2r'(r)/r^2 - z2r(r)/r^3     pair-force factor (phip/r)
    phi(u) = z2r(r)/r                     pair energy
    F(rho), F'(rho)                       embedding energy / derivative

so F_i = -sum_j dx * [(fp_i + fp_j) a(u) + b(u)] mirrors the reference's
psip assembly (src/MANYBODY/pair_eam.cpp:268-292) with fp = F'(rho).

`compute` serves the sorted (cell-major) layout and the dense cell buckets
of list mode "cell":
  - sorted force-only calls (every MD step) go to the two CUDA cell sweeps
    of ops/eam_kernels, at every grid size (the JAX package switched to
    this module's roll path above 300k rows; the port has no such
    dispatch);
  - sorted energy/virial calls (thermo rows) go to the tally instances of
    the same two sweeps (`eam_kernels.compute_tally_sorted`), counted on
    `pair.eam_tally_rows` (utils/trace);
  - every call on cell buckets takes the Newton-halved grid-roll path
    `grid_roll`, plain PyTorch, as the JAX package left it to XLA; its
    energy/virial calls count on `pair.eam_roll_rows`.
The dispatch reads only the layout's type; the wrappers of ops/eam_kernels
take the kernels for CUDA tensors and their plain twins for CPU ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.state import State
from ..utils import trace
from . import gridforce
from .cellforce import CellListDense
from .sortedforce import SortedCells

DEG = 28        # pair-function fits (per-candidate Clenshaw cost)
DEG_EMBED = 80  # embedding fits (per-atom cost)
R_LO_FRAC = 0.30  # fit from 0.3*cutoff; closer approaches clamp


def _spline_val_der(coeff: np.ndarray, n: int, delta: float, x: np.ndarray):
    """Numpy twin of the reference's 7-coeff spline evaluation
    (pair_eam.cpp interpolate(); derivative coeffs already fold 1/delta)."""
    p = x / delta + 1.0
    m = np.clip(np.floor(p).astype(int), 1, n - 1)
    p = np.clip(p - m, 0.0, 1.0)
    c = coeff[m]
    val = ((c[:, 3] * p + c[:, 4]) * p + c[:, 5]) * p + c[:, 6]
    der = (c[:, 0] * p + c[:, 1]) * p + c[:, 2]
    return val, der


def build_poly_tables(style) -> dict | None:
    """Host: Chebyshev fits (in u = r^2) from a single-type funcfl style.
    Returns None when the style is not resamplable. Costs two chebfits of
    4096 and 8192 samples: callers take the cached `style.poly_tables`."""
    if style.ntypes != 1:
        return None
    host = lambda a: a.detach().cpu().numpy()  # noqa: E731
    rhor = host(style.rhor_spline)[int(host(style.type2rhor)[1, 1])]
    z2r = host(style.z2r_spline)[int(host(style.type2z2r)[1, 1])]
    frho = host(style.frho_spline)[int(host(style.type2frho)[1])]
    nr, nrho = style.nr, style.nrho
    dr, drho = style.dr, style.drho
    rc = style.cutmax
    r_lo = R_LO_FRAC * rc

    r = np.linspace(r_lo, rc, 4096)
    rho_v, rho_d = _spline_val_der(rhor, nr, dr, r)
    z2_v, z2_d = _spline_val_der(z2r, nr, dr, r)

    u = r * r

    def fit(y, x, lo, hi, deg=DEG):
        # coefficients over the SAME [lo,hi]->[-1,1] map clenshaw uses
        t = (2.0 * x - (lo + hi)) / (hi - lo)
        return np.polynomial.chebyshev.chebfit(t, y, deg)

    u_lo, u_hi = r_lo * r_lo, rc * rc

    def cheb_der(c, lo, hi):
        # derivative SERIES of the fitted values: forces stay the exact
        # gradient of the fitted energy, so NVE conserves to integrator error
        return np.polynomial.chebyshev.chebder(c) * (2.0 / (hi - lo))

    g_c = fit(rho_v, u, u_lo, u_hi)
    phi_c = fit(z2_v / r, u, u_lo, u_hi)
    tabs = {
        "g": g_c,
        "a": 2.0 * cheb_der(g_c, u_lo, u_hi),   # drho/dx = 2 g'(u) dx
        "b": 2.0 * cheb_der(phi_c, u_lo, u_hi),  # = phip/r
        "phi": phi_c,
    }
    # embedding: F(rho) ~ -c sqrt(rho) near 0 (F' diverges), so fit in
    # s = sqrt(rho) over [s_lo, s_max]; below s_lo the inputs clamp
    rho_hi = style.rhomax
    s_hi = np.sqrt(rho_hi)
    s_lo = 0.3 * s_hi  # rho >= 9% of table max: the dense-solid regime
    sg = np.linspace(s_lo, s_hi, 8192)
    f_v, _ = _spline_val_der(frho, nrho, drho, sg * sg)
    F_c = fit(f_v, sg, s_lo, s_hi, DEG_EMBED)
    tabs["F"] = F_c
    # F'(rho) = F_s'(s) / (2 s), consistent with the fitted F
    tabs["Fp_s"] = cheb_der(F_c, s_lo, s_hi)
    tabs["u_range"] = (u_lo, u_hi)
    tabs["s_range"] = (s_lo, s_hi)
    tabs["rho_range"] = (s_lo * s_lo, rho_hi)
    return tabs


def clenshaw(c: np.ndarray, x: torch.Tensor, lo: float,
              hi: float) -> torch.Tensor:
    """Chebyshev series evaluation with host coefficients, two elementwise
    ops per degree: b_k = (c_k - b_{k+2}) + t2 * b_{k+1}."""
    t = (2.0 * x - (lo + hi)) / (hi - lo)
    t2 = 2.0 * t
    b0 = torch.zeros_like(x)
    b1 = torch.zeros_like(x)
    for k in range(len(c) - 1, 0, -1):
        b0, b1 = torch.addcmul(float(c[k]) - b1, t2, b0), b0
    return t * b0 - b1 + float(c[0])


def embedding_fp(tabs: dict, rho: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """fp = F'(rho) per row through the embedding fit in s = sqrt(rho);
    0 on padding rows."""
    rho_lo, rho_hi = tabs["rho_range"]
    s_lo, s_hi = tabs["s_range"]
    s = torch.sqrt(torch.clamp(rho, rho_lo, rho_hi))
    return torch.where(valid, clenshaw(tabs["Fp_s"], s, s_lo, s_hi)
                       / (2.0 * s), 0.0)


def embedding_energy(tabs: dict, rho: torch.Tensor, fp: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """F(rho) per row through the embedding fit in s = sqrt(rho), extended
    linearly with slope fp = F'(rho) above rho_hi; 0 where `valid` is
    false."""
    rho_lo, rho_hi = tabs["rho_range"]
    s_lo, s_hi = tabs["s_range"]
    s = torch.sqrt(torch.clamp(rho, rho_lo, rho_hi))
    return torch.where(valid, clenshaw(tabs["F"], s, s_lo, s_hi)
                       + torch.where(rho > rho_hi, fp * (rho - rho_hi), 0.0),
                       0.0)


def compute(style, state: State, cl, eflag: bool, vflag: bool):
    """Dense two-pass EAM over the sorted layout or the dense cell buckets
    (ops/cellforce), in the list's layout. Returns (f, pe, virial);
    pe/virial are None unless requested."""
    if not isinstance(cl, (SortedCells, CellListDense)):
        raise NotImplementedError(
            "dense EAM is ported for the sorted layout and the cell "
            "buckets only")
    if not all(state.box.periodic):
        raise NotImplementedError(
            "dense EAM is ported for fully periodic boxes only")
    tabs = style.poly_tables
    if tabs is None:
        raise NotImplementedError("dense EAM needs a single-type style")

    if isinstance(cl, SortedCells):
        from .eam_kernels import compute_force_sorted, compute_tally_sorted

        if not eflag and not vflag:
            return compute_force_sorted(style, tabs, state, cl), None, None
        trace.count("pair.eam_tally_rows")
        f, pe, virial = compute_tally_sorted(style, tabs, state, cl)
        return f, pe if eflag else None, virial if vflag else None
    if eflag or vflag:
        trace.count("pair.eam_roll_rows")
    return grid_roll(style, state, cl, eflag, vflag)


def grid_roll(style, state: State, cl, eflag: bool, vflag: bool):
    """The Newton-halved grid-roll pass in plain PyTorch, on the sorted
    layout or the dense cell buckets. `compute` takes it for cell buckets;
    on the sorted layout the tests hold the sweeps' twins against it.
    Returns (f, pe, virial) as `compute` does."""
    tabs = style.poly_tables
    sorted_layout = isinstance(cl, SortedCells)
    p = cl.params
    nx, ny, nz = p.ncells
    ntot = p.total_cells
    cc = p.cell_cap
    cap = state.capacity
    dt = state.dtype
    if sorted_layout:
        xg = state.x.reshape(nx, ny, nz, cc, 3)
        vg = state.valid_mask.reshape(nx, ny, nz, cc)
        og = vg  # every valid row owned
    else:
        # read the atom-ordered state through the buckets (every pass, as
        # the JAX package's cell path does; no kernel in either package)
        bidx = torch.clamp(cl.buckets[:ntot], max=cap - 1).long()
        xg = state.x[bidx].reshape(nx, ny, nz, cc, 3)
        vg = (cl.buckets[:ntot] < cap).reshape(nx, ny, nz, cc)
        og = state.owned_mask[bidx].reshape(nx, ny, nz, cc) & vg

    u_lo, u_hi = tabs["u_range"]
    cutsq = float(style.cutmax) ** 2

    def pair_u(xi, xj, vi, vj, pair_mask):
        dx = state.box.min_image(xi[..., :, None, :] - xj[..., None, :, :])
        u = torch.sum(dx * dx, dim=-1)
        valid = vi[..., :, None] & vj[..., None, :] & (u < cutsq)
        if pair_mask is not None:
            valid = valid & pair_mask
        us = torch.clamp(torch.where(valid, u, u_hi), u_lo, u_hi)
        return dx, us, valid

    lane = torch.arange(cc, device=state.device)
    notself = lane[:, None] != lane[None, :]

    def roll_pass(term_fn, extra=None):
        """Newton-halved sweep: term_fn(dx, us, valid, ex_i, ex_j, half)
        -> (per_i, per_j, tallies). The self cell sees both orders of each
        pair; the 13 half offsets see each pair once and roll the reaction
        back onto the neighbour cell."""
        ex_i = extra[..., :, None] if extra is not None else None
        ex_j = extra[..., None, :] if extra is not None else None
        dx, us, valid = pair_u(xg, xg, vg, vg, notself)
        acc_i, _, acc_t = term_fn(dx, us, valid, ex_i, ex_j, half=False)
        for off in gridforce.HALF_OFFSETS:
            xj = gridforce._roll3(xg, off, -1)
            vj = gridforce._roll3(vg, off, -1)
            exj = (gridforce._roll3(extra, off, -1)[..., None, :]
                   if extra is not None else None)
            dx, us, valid = pair_u(xg, xj, vg, vj, None)
            out_i, out_j, tallies = term_fn(dx, us, valid, ex_i, exj,
                                            half=True)
            acc_i = acc_i + out_i + gridforce._roll3(out_j, off, +1)
            if tallies is not None:
                acc_t = acc_t + tallies if acc_t is not None else tallies
        return acc_i, acc_t

    # ---- pass 1: density --------------------------------------------------
    def rho_term(dx, us, valid, ex_i, ex_j, half):
        g = torch.where(valid, clenshaw(tabs["g"], us, u_lo, u_hi), 0.0)
        return g.sum(-1), g.sum(-2), None

    rho, _ = roll_pass(rho_term)
    rho = torch.where(vg, rho, 0.0)
    fp = embedding_fp(tabs, rho, vg)

    # ---- pass 2: forces (+ pair energy/virial) ----------------------------
    def force_term(dx, us, valid, fp_i, fp_j, half):
        a = clenshaw(tabs["a"], us, u_lo, u_hi)
        b = clenshaw(tabs["b"], us, u_lo, u_hi)
        fpair = torch.where(valid, -((fp_i + fp_j) * a + b), 0.0)
        fij = dx * fpair[..., None]
        w_i = og[..., :, None].to(dt)
        w = w_i if half else w_i * 0.5
        parts = []
        if eflag:
            phi = torch.where(valid, clenshaw(tabs["phi"], us, u_lo, u_hi),
                              0.0)
            parts.append(torch.sum(phi * w))
        if vflag:
            wf = fpair * w
            parts.extend([
                torch.sum(wf * dx[..., 0] * dx[..., 0]),
                torch.sum(wf * dx[..., 1] * dx[..., 1]),
                torch.sum(wf * dx[..., 2] * dx[..., 2]),
                torch.sum(wf * dx[..., 0] * dx[..., 1]),
                torch.sum(wf * dx[..., 0] * dx[..., 2]),
                torch.sum(wf * dx[..., 1] * dx[..., 2]),
            ])
        return (torch.sum(fij, dim=-2), -torch.sum(fij, dim=-3),
                torch.stack(parts) if parts else None)

    f_grid, tallies = roll_pass(force_term, extra=fp)

    pe = virial = None
    idx = 0
    if eflag:
        pe = torch.sum(embedding_energy(tabs, rho, fp, og)) + tallies[0]
        idx = 1
    if vflag:
        virial = tallies[idx:idx + 6]
    f_flat = f_grid.reshape(-1, 3)
    if sorted_layout:
        return f_flat, pe, virial
    # back to atom order; empty lanes are dropped
    f = torch.zeros_like(state.x)
    keep = vg.reshape(-1)
    f[cl.buckets[:ntot].reshape(-1)[keep].long()] = f_flat[keep]
    return f, pe, virial
