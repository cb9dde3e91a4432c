"""The two lj cell kernels against an earlier tree's, in turns on the same
inputs, on the card.

The kernels are `csrc/lj_cell_force.cu` (K1/K2/K3's port, the sorted main
path) and `csrc/lj_cell_dense.cu` (K6's port, list mode "cell"). `--parent
DIR` names a directory holding an earlier tree's `lj_cell_force.cu`,
`lj_cell_dense.cu` and the headers they include; its two sources are built
beside this tree's (ops/cuda_build, one nvcc each, all started together)
and launched through the same C entry points, which take the same
arguments in both trees.

Inputs: the bench/in.lj melt (`presets.lj_melt_sim`, seed 87287) at cells
20 (32,000 atoms) and 63 (1,000,188 atoms), list modes "sorted" (32k, 1M)
and "cell" (32k-cell, 1M-cell), real rows jittered by a seeded +-0.05;
f32 and f64. Both kernels are first held against the plain twin (f32 rtol
1e-4, f64 1e-10, atol rtol * max|f|), then timed by their device time per
call: torch.profiler's summed device-op time of `inner` calls, the two in
turns, the median of `rounds`.

Run on the card, from the repository root:
  python -m lammps_kokkos_port_tpu_torch.prof.lj_redesign --parent DIR
      [--rounds 5] [--inner 20] [--out results.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from ..ops import cell_kernels, cuda_build, pair_kernels
from ..presets import lj_melt_sim
from .redesign import (SEED, card, check, device_times, jittered,
                       parent_library, registers)
from .timing import say

_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the two kernels' C entry points, the same in both trees
ARGTYPES = {"lj_cell_force": [_PTR] * 7 + [_I32] * 4 + [_F64] * 3 + [_PTR],
            "lj_cell_dense": [_PTR] * 5 + [_I32] * 3 + [_F64] * 3 + [_PTR]}


def _jittered(sim, dtype):
    return jittered(sim, dtype, 0.05)


def force_calls(sim, dtype, parent) -> tuple:
    """(the plain twin, {"parent": call, "new": call}) of lj_cell_force on
    `sim`'s jittered sorted grid."""
    p = sim.nl.params
    g = _jittered(sim, dtype).t().contiguous().reshape(3, p.total_cells,
                                                       p.cell_cap)
    prd = sim.state.box.prd.to(dtype)
    key = sim.pair_style.kernel_key()
    out = torch.empty_like(g)
    fn = getattr(parent, "lj_cell_force_f32" if dtype == torch.float32
                 else "lj_cell_force_f64")
    ptrs = [a.data_ptr() for a in (g[0], g[1], g[2], prd, out[0], out[1],
                                   out[2])]

    def run_parent():
        stream = torch.cuda.current_stream().cuda_stream
        if fn(*ptrs, *p.ncells, p.cell_cap, *key[1:], stream) != 0:
            raise RuntimeError("parent lj_cell_force launch failed")
        return out

    args = (key, p.ncells, g[0], g[1], g[2], prd)
    return (lambda: pair_kernels.lj_cell_force_reference(*args),
            {"parent": run_parent,
             "new": lambda: pair_kernels.lj_cell_force(*args)})


def dense_calls(sim, dtype, parent) -> tuple:
    """(the plain twin, {"parent": call, "new": call}) of lj_cell_dense on
    `sim`'s buckets with jittered positions."""
    cl = sim.nl
    x = _jittered(sim, dtype)
    prd = sim.state.box.prd.to(dtype)
    key = sim.pair_style.kernel_key()
    ntot, cc = cl.buckets.shape[0] - 1, cl.buckets.shape[1]
    f = torch.zeros_like(x)
    fn = getattr(parent, "lj_cell_dense_f32" if dtype == torch.float32
                 else "lj_cell_dense_f64")
    ptrs = [a.data_ptr() for a in (cl.buckets, cl.stencil, x, prd, f)]

    def run_parent():
        stream = torch.cuda.current_stream().cuda_stream
        if fn(*ptrs, ntot, cc, x.shape[0], *key[1:], stream) != 0:
            raise RuntimeError("parent lj_cell_dense launch failed")
        return f

    args = (key, cl.buckets, cl.stencil, x, prd)
    return (lambda: cell_kernels.lj_cell_dense_reference(*args),
            {"parent": run_parent,
             "new": lambda: cell_kernels.lj_cell_dense(*args)})


def main(parent: str, rounds: int = 5, inner: int = 20,
         out: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("lj_redesign needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()
    say(smi)
    new_src = (pair_kernels.SOURCE, cell_kernels.SOURCE)
    old_src = tuple(Path(parent) / s.name for s in new_src)
    cuda_build.build(*new_src, *old_src)
    libs = {s.stem: parent_library(s, {s.stem: ARGTYPES[s.stem]})
            for s in old_src}
    regs = {f"{s.stem} {tree}": registers(s)
            for tree, srcs in (("parent", old_src), ("new", new_src))
            for s in srcs}
    say("[registers] ptxas, per kernel (f32, f64 in build order): "
        + "; ".join(f"{k} {v}" for k, v in regs.items()))

    results = {"device": smi, "rounds": rounds, "inner": inner,
               "registers": regs}
    for cells, size in ((20, "32k"), (63, "1M")):
        for mode, make, stem in (("sorted", force_calls, "lj_cell_force"),
                                 ("cell", dense_calls, "lj_cell_dense")):
            sim = lj_melt_sim(cells=cells, t_init=1.44, seed=SEED,
                              dtype=torch.float32, device=dev,
                              list_mode=mode)
            sim.setup()
            label = size if mode == "sorted" else f"{size}-cell"
            p = sim.nl.params
            for dtype in (torch.float32, torch.float64):
                plain, calls = make(sim, dtype, libs[stem])
                ref = plain()
                errs = {k: check(f"{label} {dtype} {k}", fn(), ref, dtype)
                        for k, fn in calls.items()}
                ms = device_times(calls, rounds, inner)
                tag = f"{label} {str(dtype).split('.')[-1]}"
                results[tag] = {"grid": list(p.ncells), "cc": p.cell_cap,
                                "ms": ms, "max_abs_err": errs}
                say(f"[{tag}] grid {p.ncells} x cc {p.cell_cap}, device ms "
                    "per call: " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in ms.items())
                    + f", new / parent {ms['new'] / ms['parent']:.3f}")
            del sim
            torch.cuda.empty_cache()
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with an earlier tree's lj_cell_force.cu,"
                         " lj_cell_dense.cu and the headers they include")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--inner", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args()
    main(args.parent, args.rounds, args.inner, args.out)
