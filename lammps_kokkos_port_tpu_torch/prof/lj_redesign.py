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
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import cell_kernels, cuda_build, pair_kernels
from ..presets import lj_melt_sim
from .timing import say

SEED = 87287
# a trace may miss the device events of a ctypes launch: try again
TRACE_ATTEMPTS = 5


def registers(source: Path) -> list:
    """ptxas's register counts of a source's kernels, from its build log
    (f32 and f64 in the compiler's order)."""
    log = cuda_build.lib_path(source).with_suffix(".log")
    if not log.exists():
        return []
    return [int(line.split("Used ")[1].split()[0])
            for line in log.read_text().splitlines() if "Used " in line]


def parent_library(source: Path) -> ctypes.CDLL:
    """The earlier tree's library of `source`, its two entry points bound
    as this tree's are."""
    lib = cuda_build.load(source)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    nptr, nint = (7, 4) if source.stem == "lj_cell_force" else (5, 3)
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"{source.stem}_{suffix}")
        fn.argtypes = [ptr] * nptr + [i32] * nint + [f64] * 3 + [ptr]
        fn.restype = i32
    return lib


def _jittered(sim, dtype):
    st = sim.state
    gen = torch.Generator(device=st.device).manual_seed(SEED)
    jitter = (torch.rand(st.x.shape, generator=gen, device=st.device,
                         dtype=torch.float64) - 0.5) * 0.1
    return torch.where(st.valid_mask[:, None], st.x.double() + jitter,
                       st.x.double()).to(dtype)


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


def check(label: str, got, ref, dtype) -> float:
    """got within rtol * (max|ref| + |ref|) of ref; the max abs error."""
    torch.cuda.synchronize()
    rtol = 1e-4 if dtype == torch.float32 else 1e-10
    err = (got - ref).abs()
    vmax = ref.abs().max().item()
    bad = int((err > rtol * vmax + rtol * ref.abs()).sum())
    if bad or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: {bad} values out of tolerance")
    return err.max().item()


def device_times(calls: dict, rounds: int, inner: int) -> dict:
    """Device time per call (ms) of each of `calls`: the summed device-op
    time of `inner` calls in one torch.profiler trace, the calls in turns,
    the median of `rounds`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = {k: [] for k in calls}
    for _ in range(rounds):
        for k, fn in calls.items():
            for _ in range(TRACE_ATTEMPTS):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(inner):
                        fn()
                    torch.cuda.synchronize()
                us = sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
                if us > 0:
                    break
            else:
                raise RuntimeError(f"no device time in the traces of {k}")
            times[k].append(us / inner / 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def main(parent: str, rounds: int = 5, inner: int = 20,
         out: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("lj_redesign needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    say(smi)
    new_src = (pair_kernels.SOURCE, cell_kernels.SOURCE)
    old_src = tuple(Path(parent) / s.name for s in new_src)
    cuda_build.build(*new_src, *old_src)
    libs = {s.stem: parent_library(s) for s in old_src}
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
