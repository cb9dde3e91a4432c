"""The Newton-half column pass split into its costs, on the card.

Counterpart of benchmarks/prof/prof_kernel_iso.py on the bench/in.lj melt
(`prof.grid.melt_sim`: cells 20, 32,000 atoms, f32, at setup). It prints
the script's line for each mode of P5 (prof/column_half_kernels `iso_*`):

  full        K8's forces, each reaction landed on its candidate's row;
  batched     the same forces, the reactions landed by (dx, dy) target and
              z, then gathered by a fold;
  redonly     the forward sums plus the own block's reactions;
  noreverse   the forward sums only;
  noassembly  the candidates never staged, every slot walked as a NaN
              candidate (every output NaN);

each the slope of k = 100 and 300 iterations of `carry + EPS * f`, best of
3, as the script's `scan_time`; `batched` adds its max abs difference from
`full` ("parity vs full": the same forces, summed in another order).
`full` - `redonly` is the cost of landing the 13 neighbour blocks'
reactions, `redonly` - `noreverse` that of the own block's; on the card's
walk, which prunes the candidates, `noassembly` walks every slot and so
times more pairs than `full` (csrc/lj_column_half.cu).

Run on the card: `python -m lammps_kokkos_port_tpu_torch.prof.kernel_iso`;
on the CPU: `main(cells=6, device="cpu", k1=1, k2=2, reps=1)`.
"""

from __future__ import annotations

import argparse

import torch

from ..utils.device import resolve
from . import column_half_kernels as chk
from .grid import melt_sim, sorted_planes
from .timing import device_line, force_body, say, slope_ms

MODES = ("full", "batched", "redonly", "noreverse", "noassembly")


def main(cells: int = 20, device="cuda", k1: int = 100, k2: int = 300,
         reps: int = 3, sim=None) -> dict:
    """Print the script's lines; return {mode: ms} and the parity. `sim`:
    a set-up sorted Simulation on `device` in place of the melt of
    `cells`."""
    dev = resolve(device)
    say(device_line(dev))
    sim = melt_sim(cells, dev) if sim is None else sim
    sp = sorted_planes(sim)
    gx, gy, gz, gi = sp.col
    say(f"natoms={sp.natoms} ncells={sp.ncells} cc={sp.cc} cap={sp.cap}")
    out, ref = {}, None
    for mode in MODES:
        fn = chk.PASSES[f"iso_{mode}"]

        def forces(cgx, cgy, cgz, fn=fn):
            return fn(sp.key, sp.ncells, sp.cap, cgx, cgy, cgz, gi, sp.prd)

        out[mode] = slope_ms(force_body(forces), (gx, gy, gz), k1, k2, reps)
        note = ""
        if mode in ("full", "batched"):
            f = forces(gx, gy, gz)
            if ref is None:
                ref = f
            else:
                out["parity vs full"] = max(
                    float(torch.max(torch.abs(a - b))) for a, b in zip(ref, f))
                note = f"  parity vs full: {out['parity vs full']:.2e}"
        say(f"{mode:12s}: {out[mode]:.3f} ms{note}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(cells=args.cells, device=args.device)
