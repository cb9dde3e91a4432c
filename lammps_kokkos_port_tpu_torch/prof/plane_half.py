"""The Newton-half plane kernel against the full stencil, on the card.

Counterpart of benchmarks/prof/prof_v3_32k.py (at cells 20, 32,000 atoms)
and prof_v3_iso.py (at cells 63, 1,000,188 atoms), on the bench/in.lj melt
(`lj_melt_sim(cells, t_init=1.44, seed=87287, every=20, delay=0,
check=False)`, f32). It prints, under the scripts' labels:

  parity col vs v3    max abs difference between the port's lj kernel
                      (ops/pair_kernels.lj_cell_force, the counterpart of
                      K1 column_half_force_pallas) and K8
                      (ops/half_kernels.lj_plane_half_force), at every size;
  prof_v3_32k.py's    `column_half 32k` (lj_cell_force) and
                      `plane_half_v3 32k` (K8): slope of k = 100 and 300,
                      best of 3;
  prof_v3_iso.py's    `v3 shipped` (K8) and `v3 forward-only` (P10,
                      ops/half_kernels.lj_plane_half_fwd): k = 10 and 30,
                      best of 3.

At cells 20 it prints the first script's lines, at cells 63 the second's,
at any other size both. The labels keep the scripts' words ("32k" in
particular), whatever the size; the header line names it.

Run on the card: `python -m lammps_kokkos_port_tpu_torch.prof.plane_half
--cells 63`; on the CPU: `main(cells=6, device="cpu", k1=1, k2=2,
reps=1)`.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.half_kernels import lj_plane_half_force, lj_plane_half_fwd
from ..ops.pair_kernels import lj_cell_force
from ..utils.device import resolve
from .grid import melt_sim, sorted_planes
from .timing import device_line, force_body, say, slope_ms

# the scripts' slope lengths: (k1, k2)
K_32K = (100, 300)
K_ISO = (10, 30)


def main(cells: int = 20, device="cuda", k1: int | None = None,
         k2: int | None = None, reps: int = 3, sim=None) -> dict:
    """Print the scripts' lines; return {label: value}. k1/k2 override the
    scripts' slope lengths; `sim`: a set-up sorted Simulation on `device`
    to profile in place of building the melt of `cells`."""
    dev = resolve(device)
    lines = {20: "32k", 63: "iso"}.get(cells, "both")
    say(device_line(dev))
    sim = melt_sim(cells, dev) if sim is None else sim
    sp = sorted_planes(sim)
    key, prd, cap, cc = sp.key, sp.prd, sp.cap, sp.cc
    say(f"natoms={sp.natoms} ncells={sp.ncells} cc={cc} cap={cap}")
    gx4, gy4, gz4, gi4 = sp.plane
    out = {}

    def col(cgx, cgy, cgz):
        return lj_cell_force(key, sp.ncells, *(a.reshape(-1, cc)
                                               for a in (cgx, cgy, cgz)), prd)

    def v3(cgx, cgy, cgz):
        return lj_plane_half_force(key, sp.ncells, cap, cgx, cgy, cgz, gi4,
                                   prd)

    def fwd(cgx, cgy, cgz):
        return lj_plane_half_fwd(key, sp.ncells, cap, cgx, cgy, cgz, gi4,
                                 prd)

    # parity
    f0 = col(gx4, gy4, gz4)
    f1 = v3(gx4, gy4, gz4)
    out["parity col vs v3"] = max(
        float(torch.max(torch.abs(a.reshape(-1) - b.reshape(-1))))
        for a, b in zip(f0, f1))
    say(f"parity col vs v3: {out['parity col vs v3']:.2e}")

    carry = (gx4, gy4, gz4)
    timed = []
    if lines in ("32k", "both"):
        timed += [("column_half 32k", col, K_32K, 3),
                  ("plane_half_v3 32k", v3, K_32K, 3)]
    if lines in ("iso", "both"):
        timed += [("v3 shipped     ", v3, K_ISO, 2),
                  ("v3 forward-only", fwd, K_ISO, 2)]
    for label, forces, (s1, s2), digits in timed:
        t = slope_ms(force_body(forces), carry, k1 or s1, k2 or s2, reps)
        out[label.strip()] = t
        say(f"{label}: {t:.{digits}f} ms")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(cells=args.cells, device=args.device)
