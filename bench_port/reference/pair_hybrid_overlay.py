"""The reference of `pair_style hybrid/overlay zbl <inner> <outer> snap`
(one element, one type), in plain PyTorch.

SNAP (A. P. Thompson et al., J. Comput. Phys. 285, 316 (2015); LAMMPS
src/ML-SNAP): for each atom i, the density of its neighbours within
rcut = 2 radelem rcutfac on the 3-sphere, expanded in Wigner U functions,

    U_j(i)  = wself I + sum_k fc(r_ik) wj u_j(r_ik),   j = 0 .. twojmax
    fc(r)   = 1/2 (cos(pi (r - rmin0) / (rcut - rmin0)) + 1)
    u_j     from the Cayley-Klein parameters of the rotation of angle
              theta0 = rfac0 pi (r - rmin0) / (rcut - rmin0) about r_ik:
              a = (z0 - i z) / r0, b = (y - i x) / r0, z0 = r / tan(theta0),
              r0 = sqrt(r^2 + z0^2), by the recursion of Varshalovich,
              Moskalev and Khersonskii 4.8.2 (rows mb < j), the last row by
              the symmetry U[j-mb][j-ma] = (-1)^(ma+mb) conj(U[mb][ma]);
    Z       = C^T (U_j1 (x) U_j2) C, C the Clebsch-Gordan coefficients
              <j1 m1 j2 m2 | j m> (Racah's formula), per (j1, j2, j);
    B       = sum over all mb, ma of Re[conj(U_j) Z] (less j + 1 with
              bzeroflag), for j2 <= j1 <= j;
    E_i     = beta_0 + sum_b beta_b B_b.

ZBL (Ziegler, Biersack and Littmark; LAMMPS src/pair_zbl.cpp): the
screened Coulomb pair energy Zi Zj e^2/r sum_k c_k exp(-d_k r / a) and
LAMMPS's polynomial switch S(r) on (inner, outer], which takes E and its
first two derivatives to 0 at the outer cutoff.

The energies are functions of the displacements d = x_j - x_i of the
directed pairs (SNAP) and of the half pairs (ZBL); the forces are -dE/dx by
torch.autograd over them: f_i += g, f_j -= g with g = dE/dd. The virial is
-sum d (x) g, the pressure scale's `virial_abs` sum |d . g|. SNAP goes by
blocks of centre atoms, ATOM_BLOCK a block: an atom's energy depends only
on its own displacements, so each block is differentiated on its own.
Arithmetic follows `prec` (models.py): the displacements and every term in
`prec.pair`, the forces and sums in `prec.state`; TF32 is turned off
around the matrix products.

`band` is all zeros: fc and fc' are 0 at rcut, and ZBL's E and E' are 0 at
the outer cutoff, so a pair a rounded cutoff decision takes in or leaves
out adds no force.

Departures from LAMMPS, none of which moves a result by more than
rounding: B is the full sum over U_j (LAMMPS sums the left half and
doubles it); the recursion runs every row below the last (LAMMPS runs the
rows mb <= j/2 and copies the rest by the symmetry); forces by autograd,
not the adjoint (compute_yi, compute_deidrj). Only one element, one atom
type, linear SNAP (quadraticflag 0) and LAMMPS's default flags otherwise
(switchflag 1, bnormflag 0, wselfallflag 0, chemflag 0).
"""

from __future__ import annotations

import contextlib
import math
from fractions import Fraction

import torch

from bench_port.reference.models import Result
from bench_port.reference.neighbors import min_image

ATOM_BLOCK = 8192
# the ZBL screening function (Ziegler, Biersack and Littmark 1985; LAMMPS
# src/pair_zbl_const.h): sum_k c_k exp(-d_k r / a), a = 0.46850 /
# (Zi^0.23 + Zj^0.23)
ZBL_C = (0.18175, 0.50986, 0.28022, 0.02817)
ZBL_D = (3.19980, 0.94229, 0.40290, 0.20162)
ZBL_A0, ZBL_P = 0.46850, 0.23
QQR2E_METAL = 14.399645


# ---- the files -------------------------------------------------------------

def _words(path):
    out = []
    with open(path) as f:
        for line in f:
            w = line.split("#")[0].split()
            if w:
                out.append(w)
    return out


def read_include(path: str) -> dict:
    """The overlay's numbers from the deck's include file: its variables,
    the pair_style line (continued by &) and the pair_coeff lines."""
    text = open(path).read().replace("&\n", " ")
    var, style, coeff = {}, None, []
    for line in text.splitlines():
        w = line.split("#")[0].split()
        if w[:1] == ["variable"] and w[2] == "equal":
            var[w[1]] = w[3]
        elif w[:1] == ["pair_style"]:
            style = w[1:]
        elif w[:1] == ["pair_coeff"]:
            coeff.append(w[1:])

    def sub(t):
        return var[t[2:-1]] if t.startswith("${") else t

    if style is None or style[0] != "hybrid/overlay":
        raise NotImplementedError(f"{path}: the reference takes "
                                  "pair_style hybrid/overlay zbl .. snap")
    style = [sub(t) for t in style]
    zi = style.index("zbl")
    out = {"zbl_inner": float(style[zi + 1]),
           "zbl_outer": float(style[zi + 2])}
    for c in coeff:
        c = [sub(t) for t in c]
        if c[2] == "zbl":
            out["z"] = (float(c[3]), float(c[4]))
        elif c[2] == "snap":
            out["snapcoeff"], out["snapparam"] = c[3], c[4]
    return out


def read_snap(coeff_path: str, param_path: str) -> dict:
    """One element's radelem, wj, coefficients and the .snapparam keys."""
    w = _words(coeff_path)
    nelem, ncoeff = int(w[0][0]), int(w[0][1])
    if nelem != 1:
        raise NotImplementedError("the reference takes one element")
    p = {"radelem": float(w[1][1]), "wj": float(w[1][2]),
         "coeff": [float(v[0]) for v in w[2:2 + ncoeff]],
         "rfac0": 0.99363, "rmin0": 0.0, "bzeroflag": 1, "switchflag": 1,
         "quadraticflag": 0}
    for k, v in _words(param_path):
        p[k] = float(v)
    for k in ("quadraticflag", "chemflag", "bnormflag", "wselfallflag"):
        if p.get(k, 0):
            raise NotImplementedError(f"the reference takes {k} 0")
    if not p["switchflag"]:
        raise NotImplementedError("the reference takes switchflag 1")
    p["twojmax"] = int(p["twojmax"])
    return p


# ---- Clebsch-Gordan coefficients and the components ------------------------

def _f(n2: int) -> int:
    """(n2 / 2)! of an even n2."""
    return math.factorial(n2 // 2)


def clebsch_gordan(j1: int, m1: int, j2: int, m2: int, j: int, m: int):
    """<j1/2 m1/2, j2/2 m2/2 | j/2 m/2> of doubled arguments by Racah's
    formula (Condon-Shortley phases), in exact arithmetic."""
    if m1 + m2 != m or not abs(j1 - j2) <= j <= j1 + j2 or (
            j1 + j2 + j) % 2:
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m) > j:
        return 0.0
    pre = Fraction((j + 1) * _f(j + j1 - j2) * _f(j - j1 + j2)
                   * _f(j1 + j2 - j), _f(j1 + j2 + j + 2))
    pre *= (_f(j + m) * _f(j - m) * _f(j1 - m1) * _f(j1 + m1) * _f(j2 - m2)
            * _f(j2 + m2))
    total = Fraction(0)
    for k in range(0, j1 + j2 + 1):
        args = (j1 + j2 - j - 2 * k, j1 - m1 - 2 * k, j2 + m2 - 2 * k,
                j - j2 + m1 + 2 * k, j - j1 - m2 + 2 * k)
        if min(args) < 0:
            continue
        den = math.factorial(k)
        for a in args:
            den *= _f(a)
        total += Fraction((-1) ** k, den)
    return float(total) * math.sqrt(pre)


def components(twojmax: int):
    """(j1, j2, j) of the bispectrum, j2 <= j1 <= j (all doubled)."""
    return [(j1, j2, j) for j1 in range(twojmax + 1)
            for j2 in range(j1 + 1)
            for j in range(j1 - j2, min(twojmax, j1 + j2) + 1, 2) if j >= j1]


def cg_tensor(j1: int, j2: int, j: int) -> torch.Tensor:
    """C[m1, m2, m] = <j1 (2 m1 - j1), j2 (2 m2 - j2) | j (2 m - j)>,
    float64 [j1+1, j2+1, j+1]."""
    c = torch.zeros((j1 + 1, j2 + 1, j + 1), dtype=torch.float64)
    for a in range(j1 + 1):
        for b in range(j2 + 1):
            for m in range(j + 1):
                c[a, b, m] = clebsch_gordan(j1, 2 * a - j1, j2, 2 * b - j2,
                                            j, 2 * m - j)
    return c


# ---- the model -------------------------------------------------------------

@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class ZblSnap:
    """ZBL plus linear SNAP of one element (`read_include`, `read_snap`)."""

    def __init__(self, pot: dict, snap: dict):
        self.inner, self.outer = pot["zbl_inner"], pot["zbl_outer"]
        zi, zj = pot["z"]
        self.zze = zi * zj * QQR2E_METAL
        ainv = (zi ** ZBL_P + zj ** ZBL_P) / ZBL_A0
        self.zd = [d * ainv for d in ZBL_D]
        self._zbl_switch()
        self.s = snap
        self.twojmax = snap["twojmax"]
        self.rcut = 2.0 * snap["radelem"] * snap["rcutfac"]
        self.cutoff = max(self.outer, self.rcut)
        self.comps = components(self.twojmax)
        if len(snap["coeff"]) != len(self.comps) + 1:
            raise ValueError("the coefficients do not match twojmax")
        self.cg = {c: cg_tensor(*c) for c in self.comps}

    # -- ZBL --
    def _phi(self, r, order):
        """The screened Coulomb term's value, first or second derivative
        at the float r."""
        s = [sum(c * (-d) ** k * math.exp(-d * r) for c, d in zip(
            ZBL_C, self.zd)) for k in range(3)]
        if order == 0:
            return self.zze * s[0] / r
        if order == 1:
            return self.zze * (s[1] / r - s[0] / r ** 2)
        return self.zze * (s[2] / r - 2 * s[1] / r ** 2 + 2 * s[0] / r ** 3)

    def _zbl_switch(self):
        """LAMMPS's switch: E += A/3 t^3 + B/4 t^4 + C, t = r - inner, with
        A, B from E'(outer) = E''(outer) = 0 and C from E(outer) = 0."""
        tc = self.outer - self.inner
        e, e1, e2 = (self._phi(self.outer, k) for k in range(3))
        self.swa = (-3.0 * e1 + tc * e2) / tc ** 2
        self.swb = (2.0 * e1 - tc * e2) / tc ** 3
        self.swc = -e + tc / 2.0 * e1 - tc ** 2 / 12.0 * e2

    def _zbl_energy(self, d):
        r = torch.sqrt((d * d).sum(-1))
        screen = sum(c * torch.exp(-dd * r) for c, dd in zip(ZBL_C, self.zd))
        t = (r - self.inner).clamp(min=0.0)
        e = self.zze * screen / r + self.swc + (
            self.swa / 3.0 * t ** 3 + self.swb / 4.0 * t ** 4)
        return torch.where(r < self.outer, e, 0.0)

    # -- SNAP --
    def _u_levels(self, a, b):
        """U_0..U_twojmax of each pair, [P, j+1, j+1] complex (rows mb, cols
        ma)."""
        P = a.shape[0]
        rdt = a.real.dtype
        ca, cb = a.conj()[:, None, None], b.conj()[:, None, None]
        levels = [torch.ones((P, 1, 1), dtype=a.dtype, device=a.device)]
        for j in range(1, self.twojmax + 1):
            prev = levels[-1]                            # [P, j, j]
            mb = torch.arange(j, dtype=rdt, device=a.device)[:, None]
            ma = torch.arange(j + 1, dtype=rdt, device=a.device)[None, :]
            c1 = torch.sqrt((j - ma) / (j - mb))
            c2 = torch.sqrt(ma / (j - mb))
            zero = torch.zeros((P, j, 1), dtype=a.dtype, device=a.device)
            left = torch.cat([prev, zero], -1)           # u[mb][ma]
            right = torch.cat([zero, prev], -1)          # u[mb][ma - 1]
            rows = c1 * ca * left - c2 * cb * right      # mb = 0 .. j-1
            sign = torch.tensor([(-1.0) ** k for k in range(j + 1)],
                                dtype=rdt, device=a.device)
            # U[j][ma] = (-1)^(j - ma) conj(U[0][j - ma])
            last = (sign * rows[:, 0, :].conj()).flip(-1)
            levels.append(torch.cat([rows, last[:, None, :]], 1))
        return levels

    def _snap_energy(self, d, centre, natoms):
        """Each centre atom's SNAP energy [natoms] from its directed pairs'
        displacements d [P, 3] (centre ids `centre`, 0..natoms-1)."""
        s = self.s
        cdt = torch.complex128 if d.dtype == torch.float64 else (
            torch.complex64)
        r = torch.sqrt((d * d).sum(-1))
        theta0 = (r - s["rmin0"]) * s["rfac0"] * math.pi / (
            self.rcut - s["rmin0"])
        z0 = r / torch.tan(theta0)
        r0inv = 1.0 / torch.sqrt(r * r + z0 * z0)
        a = torch.complex(r0inv * z0, -r0inv * d[:, 2]).to(cdt)
        b = torch.complex(r0inv * d[:, 1], -r0inv * d[:, 0]).to(cdt)
        fc = 0.5 * (torch.cos((r - s["rmin0"]) * math.pi
                              / (self.rcut - s["rmin0"])) + 1.0)
        w = (fc * s["wj"]).to(cdt)
        utot = []
        for j, lv in enumerate(self._u_levels(a, b)):
            acc = torch.zeros((natoms, j + 1, j + 1), dtype=cdt,
                              device=d.device)
            acc = acc.index_add(0, centre, w[:, None, None] * lv)
            utot.append(acc + torch.eye(j + 1, dtype=cdt, device=d.device))
        beta = s["coeff"]
        e = torch.full((natoms,), beta[0], dtype=d.dtype, device=d.device)
        for k, (j1, j2, j) in enumerate(self.comps):
            c = self.cg[(j1, j2, j)].to(device=d.device, dtype=d.dtype).to(
                cdt)
            u1, u2, u = utot[j1], utot[j2], utot[j]
            # Z = C^T (U1 (x) U2) C, contracted one index at a time
            wt = torch.einsum("pkl,jln->pkjn", u2, c)
            v = torch.einsum("pij,pkjn->pikn", u1, wt)
            z = torch.einsum("ikm,pikn->pmn", c, v)
            bk = (u.conj() * z).real.sum((1, 2))
            if s["bzeroflag"]:
                bk = bk - (j + 1.0)
            e = e + beta[k + 1] * bk
        return e

    def evaluate(self, x, prd, pairs, prec, energy: bool = False) -> Result:
        i, j = pairs
        n = x.shape[0]
        dev = x.device
        xs = x.to(prec.state)
        d = min_image(xs[j] - xs[i], prd.to(prec.state)).to(prec.pair)
        f = torch.zeros((n, 3), dtype=prec.state, device=dev)
        pe, vir, vabs = 0.0, [0.0] * 6, 0.0

        def tally(leaf, grad, centre, other, e):
            nonlocal pe, vabs
            gs = grad.to(prec.state)
            f.index_add_(0, centre, gs)
            f.index_add_(0, other, -gs)
            if energy:
                pe += float(e.detach().to(prec.state).sum())
                for k, (u, w) in enumerate(((0, 0), (1, 1), (2, 2), (0, 1),
                                            (0, 2), (1, 2))):
                    vir[k] -= float((leaf[:, u] * grad[:, w]).to(
                        prec.state).sum())
                vabs += float((leaf * grad).sum(-1).abs().to(
                    prec.state).sum())

        with _no_tf32():
            # ZBL on the half pairs within the outer cutoff
            r2 = (d * d).sum(-1)
            near = r2 < self.outer ** 2
            leaf = d[near].clone().requires_grad_(True)
            e = self._zbl_energy(leaf)
            (g,) = torch.autograd.grad(e.sum(), leaf)
            tally(leaf.detach(), g, i[near], j[near], e)

            # SNAP on the directed pairs within rcut, grouped by centre
            keep = (r2 < self.rcut ** 2) & (r2 > 1e-20)
            ii, jj, dd = i[keep], j[keep], d[keep]
            ci = torch.cat([ii, jj])
            order = torch.argsort(ci, stable=True)
            ci, cj = ci[order], torch.cat([jj, ii])[order]
            dd = torch.cat([dd, -dd])[order]
            deg = torch.bincount(ci, minlength=n)
            start = torch.cumsum(deg, 0) - deg
            for a0 in range(0, n, ATOM_BLOCK):
                a1 = min(n, a0 + ATOM_BLOCK)
                p0 = int(start[a0])
                p1 = int(start[a1]) if a1 < n else ci.numel()
                leaf = dd[p0:p1].clone().requires_grad_(True)
                centre = ci[p0:p1]
                e = self._snap_energy(leaf, centre - a0, a1 - a0)
                (g,) = torch.autograd.grad(e.sum(), leaf)
                tally(leaf.detach(), g, centre, cj[p0:p1], e)
        if not energy:
            return Result(f, None, None, None)
        band = torch.zeros(n, dtype=prec.state, device=dev)
        return Result(f, pe, vir, vabs, band)


def build(config: dict, potential_path, band: float):
    """(model, mass): the run's include file (and the .snapcoeff and
    .snapparam it names), read here, and the configuration's `mass`."""
    if potential_path is None:
        raise FileNotFoundError(
            "reference/pair_hybrid_overlay.py reads the run's potential "
            "file, and none was given")
    pot = read_include(potential_path)
    return (ZblSnap(pot, read_snap(pot["snapcoeff"], pot["snapparam"])),
            float(config["mass"]))
