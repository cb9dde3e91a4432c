"""Forward-only Newton-half column passes at several z chunks, on the card.

Counterpart of benchmarks/prof/prof_zchunk.py on the bench/in.lj melt
(`prof.grid.melt_sim`: cells 20, 32,000 atoms, f32, at setup). It prints,
under the script's labels:

  fwd zb=...    P11 `fwd` (prof/column_half_kernels `zchunk_fwd`: the
                forward half sums with ids, P10's function) at zb = nz,
                4, 2, 1;
  fused zb=...  P11 `fused` (`zchunk_fused`: id-free, 0 < r2 < cutsq,
                approximate reciprocal) at zb = nz, 2, 1;

each the slope of k = 20 and 60 iterations of `carry + EPS * f`, as the
script's `scan_time`. `zb` is the script's z chunk (TPU register tiling);
here it is the number of cells (one warp each, consecutive z of a column)
of one CUDA block, so each line is a launch of its own shape (the same
sums); the pass is compiled for these chunks at the 20- and 6-cell melts
(nz 12 and 3) and raises for any other.

Run on the card: `python -m lammps_kokkos_port_tpu_torch.prof.zchunk`; on
the CPU: `main(cells=6, device="cpu", k1=1, k2=2, reps=1)`.
"""

from __future__ import annotations

import argparse

from ..utils.device import resolve
from .column_half_kernels import zchunk_fused, zchunk_fwd
from .grid import melt_sim, sorted_planes
from .timing import device_line, force_body, say, slope_ms


def main(cells: int = 20, device="cuda", k1: int = 20, k2: int = 60,
         reps: int = 1, sim=None) -> dict:
    """Print the script's lines; return {label: ms}. `sim`: a set-up
    sorted Simulation on `device` in place of the melt of `cells`."""
    dev = resolve(device)
    say(device_line(dev))
    sim = melt_sim(cells, dev) if sim is None else sim
    sp = sorted_planes(sim)
    gx, gy, gz, gi = sp.col
    nz = sp.ncells[2]
    say(f"natoms={sp.natoms} ncells={sp.ncells} cc={sp.cc} cap={sp.cap}")
    out = {}
    for name, fn, zbs in (("fwd", zchunk_fwd, (nz, 4, 2, 1)),
                          ("fused", zchunk_fused, (nz, 2, 1))):
        for zb in zbs:
            def forces(cgx, cgy, cgz, fn=fn, zb=zb):
                return fn(sp.key, sp.ncells, sp.cap, cgx, cgy, cgz, gi,
                          sp.prd, zb=zb)

            label = f"{name} zb={zb:2d}"
            out[label] = slope_ms(force_body(forces), (gx, gy, gz), k1, k2,
                                  reps)
            say(f"{label:<17s}: {out[label]:.3f} ms")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(cells=args.cells, device=args.device)
