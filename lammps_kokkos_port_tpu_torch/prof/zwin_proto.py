"""The z-window column prototype on the card: prof_zwin_proto.py.

Counterpart of benchmarks/prof/prof_zwin_proto.py: P12
(prof/zwin_kernels `zwin_proto`) on the script's synthetic inputs
(`zwin_inputs`: its shapes, ncol 144, S 256, and its numpy seed 0), timed
as the script times it, the carry ex through `ex + EPS * fLx`, the slope of
k = 20 and 60 iterations (prof.timing.slope_ms: CUDA graphs on the card).
The script's line compares against TPU constants (the shipped
column_half's 0.327 ms and a 0.06 ms overhead in an atom-steps/s
projection); this one compares against the port's lj kernel
(ops/pair_kernels.lj_cell_force) on the bench/in.lj melt at `cells`
(32,000 atoms at 20), timed the same way in the same run.

Run on the card: `python -m lammps_kokkos_port_tpu_torch.prof.zwin_proto`;
on the CPU: `main(cells=6, device="cpu", k1=1, k2=2)`.
"""

from __future__ import annotations

import argparse

from ..ops.pair_kernels import lj_cell_force
from ..utils.device import resolve
from .grid import melt_sim, sorted_planes
from .timing import EPS, device_line, force_body, say, slope_ms
from .zwin_kernels import ZwinShape, zwin_inputs, zwin_proto


def main(cells: int = 20, device="cuda", k1: int = 20, k2: int = 60,
         reps: int = 1, sim=None) -> dict:
    """Print the script's line; return {label: ms}. `sim`: a set-up sorted
    Simulation on `device` in place of the melt of `cells`."""
    dev = resolve(device)
    say(device_line(dev))
    shape = ZwinShape()
    ex, ey, ez, xT, yT, zT, starts = zwin_inputs(shape, device=dev)

    def body(c):
        return c + EPS * zwin_proto(c, ey, ez, xT, yT, zT, starts)[3]

    out = {"zwin proto kernel": slope_ms(body, ex, k1, k2, reps)}
    sim = melt_sim(cells, dev) if sim is None else sim
    sp = sorted_planes(sim)

    def col(cgx, cgy, cgz):
        return lj_cell_force(sp.key, sp.ncells, *(a.reshape(-1, sp.cc)
                                                  for a in (cgx, cgy, cgz)),
                             sp.prd)

    out["lj_cell_force"] = slope_ms(force_body(col), sp.col[:3], k1, k2, reps)
    say(f"zwin proto kernel: {out['zwin proto kernel']:.4f} ms/call (ncol "
        f"{shape.ncol}, S {shape.s}, {shape.nlane} lanes; vs lj_cell_force "
        f"{out['lj_cell_force']:.4f} ms on the {sp.natoms}-atom melt, same "
        "run)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(cells=args.cells, device=args.device)
