"""The cc 32 column passes of prof_kernel_cc32.py, on the card.

Counterpart of benchmarks/prof/prof_kernel_cc32.py on the bench/in.lj melt
(`prof.grid.melt_sim`: cells 20, 32,000 atoms, f32, at setup), re-sorted at
a forced cell_cap of 32 as the script does (`prof.grid.resort`, raising on
overflow; at 32k the grid is already (12, 12, 12) x cc 32, so the re-sort
runs and checks but changes no shape). It prints, under the script's
labels:

  T1 shipped@32   the shipped half kernel, here the port's lj kernel
                  (ops/pair_kernels.lj_cell_force, the counterpart of K1
                  column_half_force_pallas);
  T2 aligned      P3 (prof/column_half_kernels `cc32_half`): Newton-half
                  forces with the mask own_id < cand_id, own_id >= 0; the
                  script's 128-lane tile grouping is TPU lane alignment and
                  has no counterpart;
  T2 vs shipped   max |T1 - T2| / max |T1| per component;
  T4 pair floor   P4 (prof/ablate_kernels `pair_only` with lanes=512): the
                  pair math against the constant candidate over 512 lanes;

each time the slope of k = 20 and 60 iterations of `carry + EPS * f`
(prof.timing.slope_ms: CUDA graphs on the card), as the script's
`scan_time`.

Run on the card: `python -m lammps_kokkos_port_tpu_torch.prof.kernel_cc32`.
On the CPU the f32 melt of 6 cells puts 33 atoms in some cells, so cc 32
overflows and raises there, as the script's assert would; the f64 melt
fits: `main(device="cpu", k1=1, k2=2, sim=s)` with `s =
presets.lj_melt_sim(cells=6, dtype=torch.float64, device="cpu")` set up.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.pair_kernels import lj_cell_force
from ..utils.device import resolve
from .ablate_kernels import pair_only
from .column_half_kernels import cc32_half
from .grid import melt_sim, sorted_planes
from .timing import device_line, force_body, say, slope_ms

CELL_CAP = 32
NPAD = 512  # T4's lanes: 14 * 32 candidates rounded up to 128-lane tiles


def main(cells: int = 20, device="cuda", k1: int = 20, k2: int = 60,
         reps: int = 1, sim=None) -> dict:
    """Print the script's lines; return {label: value}. `sim`: a set-up
    sorted Simulation on `device` in place of the melt of `cells`."""
    dev = resolve(device)
    say(device_line(dev))
    sim = melt_sim(cells, dev) if sim is None else sim
    sp = sorted_planes(sim, cell_cap=CELL_CAP)
    gx, gy, gz, gi = sp.col
    say(f"natoms={sp.natoms} ncells={sp.ncells} cc={sp.cc} cap={sp.cap}")

    def t1(cgx, cgy, cgz):
        return lj_cell_force(sp.key, sp.ncells, *(a.reshape(-1, sp.cc)
                                                  for a in (cgx, cgy, cgz)),
                             sp.prd)

    def t2(cgx, cgy, cgz):
        return cc32_half(sp.key, sp.ncells, sp.cap, cgx, cgy, cgz, gi,
                         sp.prd)

    def t4(cgx, cgy, cgz):
        return pair_only(sp.key, sp.ncells, cgx, cgy, cgz, gi, sp.prd,
                         lanes=NPAD)

    out = {}
    carry = (gx, gy, gz)
    out["T1 shipped@32"] = slope_ms(force_body(t1), carry, k1, k2, reps)
    say(f"T1 shipped@32 : {out['T1 shipped@32']:.3f} ms")
    out["T2 aligned"] = slope_ms(force_body(t2), carry, k1, k2, reps)
    say(f"T2 aligned    : {out['T2 aligned']:.3f} ms")
    for a, b, n in zip(t1(gx, gy, gz), t2(gx, gy, gz), "xyz"):
        a = a.reshape(b.shape)
        err = float(torch.max(torch.abs(a - b))
                    / (torch.max(torch.abs(a)) + 1e-30))
        out[f"T2 vs shipped f{n}"] = err
        say(f"T2 vs shipped f{n}: rel err {err:.2e}")
    out["T4 pair floor"] = slope_ms(force_body(t4), carry, k1, k2, reps)
    say(f"T4 pair floor : {out['T4 pair floor']:.3f} ms")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(cells=args.cells, device=args.device)
