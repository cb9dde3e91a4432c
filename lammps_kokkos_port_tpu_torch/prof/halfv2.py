"""The id-free Newton-half column pass (v2) against the shipped one, on the
card.

Counterpart of benchmarks/prof/prof_halfv2.py on the bench/in.lj melt
(`prof.grid.melt_sim`: cells 20, 32,000 atoms, f32, at setup). It prints,
under the script's labels:

  v2 zb=2 approx=...: max abs err   P2 (prof/column_half_kernels `halfv2`,
                    `halfv2_approx`) against the shipped column-half
                    forces, here the port's lj kernel
                    (ops/pair_kernels.lj_cell_force, the counterpart of K1
                    column_half_force_pallas);
  V0 half           lj_cell_force;
  v2 zb=... approx=...: ms   P2 at zb 2 and 4, exact and approximate
                    reciprocal;

each time the slope of k = 20 and 60 iterations of `carry + EPS * f`, as
the script's `scan_time`. `zb` is the script's z chunk (TPU register
tiling); here it is the number of cells (one warp each, consecutive z of
a column) of one CUDA block, so each zb line is a launch of its own shape
(the same forces).

Run on the card: `python -m lammps_kokkos_port_tpu_torch.prof.halfv2`; on
the CPU: `main(cells=6, device="cpu", k1=1, k2=2, reps=1)`.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.pair_kernels import lj_cell_force
from ..utils.device import resolve
from .column_half_kernels import halfv2, halfv2_approx
from .grid import melt_sim, sorted_planes
from .timing import device_line, force_body, say, slope_ms


def main(cells: int = 20, device="cuda", k1: int = 20, k2: int = 60,
         reps: int = 1, sim=None) -> dict:
    """Print the script's lines; return {label: value}. `sim`: a set-up
    sorted Simulation on `device` in place of the melt of `cells`."""
    dev = resolve(device)
    say(device_line(dev))
    sim = melt_sim(cells, dev) if sim is None else sim
    sp = sorted_planes(sim)
    gx, gy, gz, gi = sp.col
    say(f"natoms={sp.natoms} ncells={sp.ncells} cc={sp.cc} cap={sp.cap}")

    def v0(cgx, cgy, cgz):
        return lj_cell_force(sp.key, sp.ncells, *(a.reshape(-1, sp.cc)
                                                  for a in (cgx, cgy, cgz)),
                             sp.prd)

    def v2(zb, approx):
        fn = halfv2_approx if approx else halfv2
        return lambda cgx, cgy, cgz: fn(sp.key, sp.ncells, sp.cap, cgx, cgy,
                                        cgz, gi, sp.prd, zb=zb)

    out = {}
    f0 = [a.reshape(gx.shape) for a in v0(gx, gy, gz)]
    for zb, approx in ((2, False), (2, True)):
        f2 = v2(zb, approx)(gx, gy, gz)
        label = f"v2 zb={zb} approx={approx}"
        out[f"{label} err"] = max(float(torch.max(torch.abs(a - b)))
                                  for a, b in zip(f2, f0))
        scale = float(torch.max(torch.abs(f0[0])))
        say(f"{label}: max abs err {out[f'{label} err']:.3e} (scale "
            f"{scale:.2e})")
    out["V0 half"] = slope_ms(force_body(v0), (gx, gy, gz), k1, k2, reps)
    say(f"V0 half        : {out['V0 half']:.3f} ms")
    for zb in (2, 4):
        for approx in (False, True):
            label = f"v2 zb={zb} approx={approx}"
            out[label] = slope_ms(force_body(v2(zb, approx)), (gx, gy, gz),
                                  k1, k2, reps)
            say(f"{label}: {out[label]:.3f} ms")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(cells=args.cells, device=args.device)
