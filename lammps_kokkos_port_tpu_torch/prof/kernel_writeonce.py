"""The write-once Newton-half column pass against the shipped one, on the
card.

Counterpart of benchmarks/prof/prof_kernel_writeonce.py on the bench/in.lj
melt (`prof.grid.melt_sim`: cells 20, 32,000 atoms, f32, at setup). It
prints, under the script's labels:

  natoms=...        the state;
  parity f{x,y,z}   max abs difference between the shipped column-half
                    forces, here the port's lj kernel
                    (ops/pair_kernels.lj_cell_force, the counterpart of K1
                    column_half_force_pallas), and P8 folded
                    (prof/column_half_kernels.wo_half_force: the pass
                    `writeonce`, then the torch.roll fold of its rc);
  V0 shipped half   lj_cell_force;
  W  write-once     P8 with its fold;

each time the slope of k = 20 and 60 iterations of `carry + EPS * f`, as
the script's `scan_time`.

Run on the card: `python -m lammps_kokkos_port_tpu_torch.prof.kernel_writeonce`;
on the CPU: `main(cells=6, device="cpu", k1=1, k2=2, reps=1)`.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.pair_kernels import lj_cell_force
from ..utils.device import resolve
from .column_half_kernels import wo_half_force
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

    def wo(cgx, cgy, cgz):
        return wo_half_force(sp.key, sp.ncells, sp.cap, cgx, cgy, cgz, gi,
                             sp.prd)

    out = {}
    for a, b, n in zip(v0(gx, gy, gz), wo(gx, gy, gz), "xyz"):
        a = a.reshape(b.shape)
        out[f"parity f{n}"] = float(torch.max(torch.abs(a - b)))
        scale = float(torch.max(torch.abs(a)))
        say(f"parity f{n}: max abs err {out[f'parity f{n}']:.3e} (scale "
            f"{scale:.3e})")
    for label, forces in (("V0 shipped half", v0), ("W  write-once  ", wo)):
        out[label.strip()] = slope_ms(force_body(forces), (gx, gy, gz), k1,
                                      k2, reps)
        say(f"{label} : {out[label.strip()]:.3f} ms")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(cells=args.cells, device=args.device)
