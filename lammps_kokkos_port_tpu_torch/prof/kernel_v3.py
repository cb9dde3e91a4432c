"""The full-stencil column passes of prof_kernel_v3.py, on the card.

Counterpart of benchmarks/prof/prof_kernel_v3.py on the bench/in.lj melt
(`prof.grid.melt_sim`: cells 20, 32,000 atoms, f32, at setup). It prints,
under the script's labels:

  K1 full27 concat   P6 k1 (prof/v3_kernels `v3_k1`): the 27-cell
                     forces, a candidate taken when its id differs from the
                     own id and is >= 0;
  K2 col-group acc   P6 k2 (`v3_k2`): the same forces, summed per (dx, dy)
                     column of the stencil and added in group order;
  K1 vs shipped      P7, k1 once more against the shipped half kernel,
                     here the port's lj kernel (ops/pair_kernels
                     .lj_cell_force, the counterpart of K1
                     column_half_force_pallas): max |shipped - k1| / max
                     |shipped| per component;

each time the slope of k = 20 and 60 iterations of `carry + EPS * f`
(prof.timing.slope_ms: CUDA graphs on the card), as the script's
`scan_time`. The docstring's K3 (r2 by an MXU dot) has no body in the
script and no line here.

Run on the card: `python -m lammps_kokkos_port_tpu_torch.prof.kernel_v3`;
on the CPU: `main(cells=6, device="cpu", k1=1, k2=2)`.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.pair_kernels import lj_cell_force
from ..utils.device import resolve
from .grid import melt_sim, sorted_planes
from .timing import device_line, force_body, say, slope_ms
from .v3_kernels import v3_k1, v3_k2


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
    out = {}
    for label, fn in (("K1 full27 concat", v3_k1),
                      ("K2 col-group acc", v3_k2)):
        def forces(cgx, cgy, cgz, fn=fn):
            return fn(sp.key, sp.ncells, cgx, cgy, cgz, gi, sp.prd)

        out[label] = slope_ms(force_body(forces), (gx, gy, gz), k1, k2, reps)
        say(f"{label} : {out[label]:.3f} ms")
    shipped = lj_cell_force(sp.key, sp.ncells, *sp.flat[:3], sp.prd)
    for a, b, n in zip(shipped, v3_k1(sp.key, sp.ncells, gx, gy, gz, gi,
                                      sp.prd), "xyz"):
        a = a.reshape(b.shape)
        err = float(torch.max(torch.abs(a - b))
                    / (torch.max(torch.abs(a)) + 1e-30))
        out[f"K1 vs shipped f{n}"] = err
        say(f"K1 vs shipped f{n}: rel err {err:.2e}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(cells=args.cells, device=args.device)
