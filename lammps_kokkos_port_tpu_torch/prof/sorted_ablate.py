"""Dissect the sorted lj/cut pass on the card (slope timings).

Counterpart of benchmarks/prof/prof_sorted_ablate.py. On the bench/in.lj
melt (`lj_melt_sim(cells, t_init=1.44, seed=87287, every=20, delay=0,
check=False)`, f32; 32,000 atoms at cells 20) it prints, under the
script's labels:

  step         the sorted step (`sim._get_segment_runner()`), slope over
               segments of 100 and 300 steps (on the card each step a
               replay of its CUDA graph, integrate/graphs; a segment's one
               host read, at its end, cancels in the slope);
  V0 half      the port's lj kernel (ops/pair_kernels.lj_cell_force, the
               counterpart of K1 column_half_force_pallas);
  V1 full27    K7 (ops/column_kernels.lj_column_force);
  V2 asm-only, V3 pair-only, V4 pair+arcp   the P9 ablations
               (prof/ablate_kernels);
  gather K=...   a random-index row gather, plain PyTorch;
  [N,K] XLA full-list force   an [N, K] neighbour-list force prototype,
               plain PyTorch (the label is the script's; there XLA ran it).

Each kernel line is `prof.timing.slope_ms` of `carry + EPS * f`, k = 20
and 60 (CUDA-graph replays on the card), as the script's `scan_time`. The random indices are drawn with
numpy from the script's seeds (0 and 1); jax.random would give others.

Run on the card: `python -m lammps_kokkos_port_tpu_torch.prof.sorted_ablate`
(`--cells`, `--device`); on the CPU: `main(cells=6, device="cpu", k1=1,
k2=2, step_k1=2, step_k2=4)`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops.column_kernels import lj_column_force
from ..ops.pair_kernels import lj_cell_force
from ..utils.device import resolve
from . import ablate_kernels as ak
from .grid import melt_sim, sorted_planes
from .timing import EPS, device_line, force_body, say, slope_ms, sync


def main(cells: int = 20, device="cuda", k1: int = 20, k2: int = 60,
         step_k1: int = 100, step_k2: int = 300, sim=None) -> dict:
    """Print the script's lines; return {label: ms}. `sim`: a set-up
    sorted Simulation on `device` to profile in place of building the
    melt of `cells`."""
    dev = resolve(device)
    say(device_line(dev))
    sim = melt_sim(cells, dev) if sim is None else sim
    sp = sorted_planes(sim)
    cc, cap, natoms, key, prd = sp.cc, sp.cap, sp.natoms, sp.key, sp.prd
    say(f"natoms={natoms} ncells={sp.ncells} cc={cc} cap={cap} "
         f"lanes/atom={14 * cc}")
    out = {}

    # --- reference: the real step (bench protocol) -------------------------
    runner = sim._get_segment_runner()

    def seg(k):
        sync(dev)
        t0 = time.perf_counter()
        runner(sim.state, sim.nl, k)
        sync(dev)
        return time.perf_counter() - t0

    seg(step_k1)  # warm-up
    ta, tb = seg(step_k1), seg(step_k2)
    out["step"] = (tb - ta) / (step_k2 - step_k1) * 1e3
    say(f"step        : {out['step']:.3f} ms")

    gx, gy, gz, gi = sp.col
    carry = (gx, gy, gz)

    def v0(cgx, cgy, cgz):
        return lj_cell_force(key, sp.ncells, *(a.reshape(-1, cc)
                                               for a in (cgx, cgy, cgz)), prd)

    variants = [
        ("V0 half     ", v0),
        ("V1 full27   ", lambda x, y, z: lj_column_force(
            key, sp.ncells, x, y, z, gi, prd)),
        ("V2 asm-only ", lambda x, y, z: ak.asm_only(
            sp.ncells, x, y, z, gi, prd)),
        ("V3 pair-only", lambda x, y, z: ak.pair_only(
            key, sp.ncells, x, y, z, gi, prd)),
        ("V4 pair+arcp", lambda x, y, z: ak.pair_only_approx(
            key, sp.ncells, x, y, z, gi, prd)),
    ]
    for label, forces in variants:
        out[label.strip()] = slope_ms(force_body(forces), carry, k1, k2)
        say(f"{label}: {out[label.strip()]:.3f} ms")

    # --- gather microbench --------------------------------------------------
    st = sim.state
    xm = torch.cat([st.x, sp.ids[:, None]], dim=1)  # [cap, 4]

    def local_idx(k):
        off = np.random.default_rng(1).integers(-512, 512, (natoms, k))
        base = np.arange(natoms)[:, None]
        return torch.from_numpy(np.clip(base + off, 0, cap - 1)).to(dev)

    for k, local in ((96, False), (128, False), (128, True)):
        idx = (local_idx(k) if local else torch.from_numpy(
            np.random.default_rng(0).integers(0, cap, (natoms, k))).to(dev))

        def gbody(c, idx=idx):
            gathered = c[idx]  # [N, K, 4]
            return torch.cat([c[:natoms] + EPS * gathered[:, 0, :],
                              c[natoms:]])

        t = slope_ms(gbody, xm, k1, k2)
        label = f"gather K={k}{' local' if local else '      '}"
        out[label.strip()] = t
        say(f"{label}: {t:.3f} ms ({natoms * k * 16 / (t * 1e-3) / 1e9:.0f}"
             " GB/s)")

    # --- [N, K] full-list force prototype (gather + pair math) --------------
    _, lj1, lj2, cutsq = key
    for k in (96, 128):
        idx = local_idx(k)

        def nk_body(c, idx=idx):
            xj = c[idx]  # [N, K, 3]
            d = c[:natoms, None, :] - xj
            r2 = torch.sum(d * d, dim=-1)
            valid = r2 < cutsq
            r2i = 1.0 / torch.where(valid, r2, 1.0)
            r6 = r2i * r2i * r2i
            fp = torch.where(valid, r6 * (lj1 * r6 - lj2) * r2i, 0.0)
            f = torch.sum(d * fp[..., None], dim=1)  # [N, 3]
            return torch.cat([c[:natoms] + EPS * f, c[natoms:]])

        t = slope_ms(nk_body, st.x, k1, k2)
        out[f"[N,{k}] XLA full-list force"] = t
        say(f"[N,{k}] XLA full-list force: {t:.3f} ms")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(cells=args.cells, device=args.device)
