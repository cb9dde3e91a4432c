"""The two EAM sweeps against an earlier tree's, in turns on the same
inputs, on the card.

The kernels are `csrc/eam_cell.cu`'s rho sweep, which also evaluates fp =
F'(rho) in its epilogue (`ops/eam_kernels.eam_cell_rho_fp`, K4's port and
the fp glue), and its force sweep (`eam_cell_force`, K5's port). `--parent
DIR` names a directory holding an earlier tree's `eam_cell.cu` and the
headers it includes; it is built beside this tree's (ops/cuda_build, one
nvcc each, all started together) and launched through its own C entry
points (this tree's, where its rho sweep has the epilogue). An earlier
rho sweep without the epilogue is timed together with `embedding_fp`, the
glue it needed, so both sides do the same work. A third
build of this tree's source with both bodies' pairs per iteration of pass
2 flipped (two and one: registers against independent chains) is timed
beside both sweeps as "other_pairs".

Inputs: the bench/in.eam deck (`presets.eam_bulk_cu_sim`, list mode
"sorted", on the synthetic Sutton-Chen stand-in written to a temporary
directory) at cells 20 (32,000 atoms) and 63 (1,000,188 atoms), real rows
jittered by a seeded +-0.08 A; f32 and f64. Every kernel is first held
against its plain twin (f32 rtol 1e-4, f64 1e-10, atol rtol * max), then
timed by its device time per call: torch.profiler's summed device-op time
of `inner` calls, the contenders in turns, the median of `rounds`.

Run on the card, from the repository root:
  python -m lammps_kokkos_port_tpu_torch.prof.eam_redesign --parent DIR
      [--rounds 5] [--inner 20] [--out results.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import tempfile
from pathlib import Path

import torch

from ..io.eam_reader import write_sutton_chen_funcfl
from ..ops import cuda_build
from ..ops import eam_kernels as ek
from ..ops.eamdense import embedding_fp
from ..presets import eam_bulk_cu_sim
from .redesign import (card, check, device_times, jittered, parent_library,
                       registers)
from .timing import say

_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_DBL = ctypes.POINTER(ctypes.c_double)
# the earlier tree's entry points: the rho sweep without the fp epilogue
PARENT_ARGTYPES = {
    "eam_cell_rho": [_PTR] * 5 + [_I32] * 4 + [_DBL] + [_F64] * 3 + [_PTR],
    "eam_cell_force": ([_PTR] * 8 + [_I32] * 4 + [_DBL] * 2 + [_F64] * 3
                       + [_PTR])}
JITTER = 0.08


def other_pairs_source(dest: Path) -> Path:
    """This tree's eam_cell.cu and headers copied into `dest`, with both
    bodies' pairs per iteration of pass 2 flipped (2 <-> 1, in each type
    where the body chooses by type)."""
    dest.mkdir(parents=True, exist_ok=True)
    for src in cuda_build.CSRC.glob("*.cuh"):
        shutil.copy(src, dest / src.name)
    text = ek.SOURCE.read_text()
    for body in ("RhoBody", "ForceBody"):
        m = re.search(rf"struct {body} \{{.*?kPairs = ([^;]+);", text, re.S)
        text = f"{text[:m.start(1)]}3 - ({m.group(1)}){text[m.end(1):]}"
    out = dest / ek.SOURCE.name
    out.write_text(text)
    return out


def _c_array(values):
    return (ctypes.c_double * len(values))(*values)


def fused_parent(source: Path) -> bool:
    """Whether an earlier tree's rho sweep has this tree's entry points
    (the fp epilogue: an `fp` output after `rho`)."""
    return "void* rho, void* fp," in source.read_text()


def sweep_calls(sim, dtype, parent, other, fused: bool) -> dict:
    """The plain twins and the contenders of both sweeps on `sim`'s
    jittered grid: {"rho": (twin, {name: call}), "force": (...)}; every
    rho call returns (rho, fp), every force call [3, ncells, cc]. With
    `fused` the parent's rho sweep has this tree's entry points, else it
    is timed with `embedding_fp`."""
    p = sim.nl.params
    ncell, cc = p.total_cells, p.cell_cap
    g = jittered(sim, dtype, JITTER).t().contiguous().reshape(3, ncell, cc)
    prd = sim.state.box.prd.to(dtype)
    valid = sim.state.valid_mask
    tabs = sim.pair_style.poly_tables
    cutsq = float(sim.pair_style.cutmax) ** 2
    rtab, ftab = ek.rho_tab(tabs, cutsq), ek.force_tab(tabs, cutsq)
    fptab = ek.fp_tab(tabs)
    rho_args = (rtab, fptab, p.ncells, g[0], g[1], g[2], valid, prd)
    rho_ref, fp_ref = ek.eam_cell_rho_fp_reference(*rho_args)
    gfp = fp_ref.contiguous()
    f_args = (ftab, p.ncells, g[0], g[1], g[2], gfp, prd)
    sfx = "f32" if dtype == torch.float32 else "f64"
    g_arr, a_arr, b_arr = (_c_array(rtab[0]), _c_array(ftab[0]),
                           _c_array(ftab[1]))
    rho_out = torch.empty_like(g[0])
    f_out = torch.empty_like(g)
    stream = torch.cuda.current_stream().cuda_stream

    def parent_rho():
        fn = getattr(parent, f"eam_cell_rho_{sfx}")
        if fn(g[0].data_ptr(), g[1].data_ptr(), g[2].data_ptr(),
              prd.data_ptr(), rho_out.data_ptr(), *p.ncells, cc, g_arr,
              *rtab[1:], stream) != 0:
            raise RuntimeError("parent eam_cell_rho launch failed")
        return rho_out, embedding_fp(tabs, rho_out.reshape(-1),
                                     valid).reshape(ncell, cc)

    def force_of(lib, label):
        fn = getattr(lib, f"eam_cell_force_{sfx}")

        def run():
            if fn(g[0].data_ptr(), g[1].data_ptr(), g[2].data_ptr(),
                  gfp.data_ptr(), prd.data_ptr(), f_out[0].data_ptr(),
                  f_out[1].data_ptr(), f_out[2].data_ptr(), *p.ncells, cc,
                  a_arr, b_arr, *ftab[2:], stream) != 0:
                raise RuntimeError(f"{label} eam_cell_force launch failed")
            return f_out
        return run

    def rho_of(lib, label):
        fn = getattr(lib, f"eam_cell_rho_{sfx}")

        def run():
            rho, fp = torch.empty_like(g[0]), torch.empty_like(g[0])
            if fn(g[0].data_ptr(), g[1].data_ptr(), g[2].data_ptr(),
                  prd.data_ptr(), valid.data_ptr(), rho.data_ptr(),
                  fp.data_ptr(), *p.ncells, cc, g_arr, *rtab[1:],
                  _c_array(fptab[0]), *fptab[1:], stream) != 0:
                raise RuntimeError(f"{label} eam_cell_rho launch failed")
            return rho, fp
        return run

    return {
        "rho": ((rho_ref, fp_ref),
                {"parent": rho_of(parent, "parent") if fused else parent_rho,
                 "new": lambda: ek.eam_cell_rho_fp(*rho_args),
                 "other_pairs": rho_of(other, "other_pairs")}),
        "force": (ek.eam_cell_force_reference(*f_args),
                  {"parent": force_of(parent, "parent"),
                   "new": lambda: ek.eam_cell_force(*f_args),
                   "other_pairs": force_of(other, "other_pairs")})}


def _check(label: str, got, ref, dtype) -> float:
    """`check` of one output, or of each of (rho, fp); the max abs error."""
    if isinstance(ref, tuple):
        return max(check(f"{label} {part}", a, b, dtype)
                   for part, a, b in zip(("rho", "fp"), got, ref))
    return check(label, got, ref, dtype)


def main(parent: str, rounds: int = 5, inner: int = 20,
         out: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("eam_redesign needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()
    say(smi)
    old_src = Path(parent) / ek.SOURCE.name
    with tempfile.TemporaryDirectory() as tmp:
        other_src = other_pairs_source(Path(tmp) / "other_pairs")
        cuda_build.build(ek.SOURCE, old_src, other_src)
        fused = fused_parent(old_src)
        old = parent_library(old_src,
                             ek.ARGTYPES if fused else PARENT_ARGTYPES)
        other = parent_library(other_src, ek.ARGTYPES)
        regs = {tree: registers(src) for tree, src in (
            ("parent", old_src), ("new", ek.SOURCE),
            ("other_pairs", other_src))}
        pot = write_sutton_chen_funcfl(Path(tmp) / "sc.eam")
        say("[registers] ptxas, per kernel in build order: "
            + "; ".join(f"{k} {v}" for k, v in regs.items()))
        results = {"device": smi, "rounds": rounds, "inner": inner,
                   "registers": regs}
        for cells, size in ((20, "32k"), (63, "1M")):
            sim = eam_bulk_cu_sim(cells=cells, dtype=torch.float32,
                                  device=dev, potential_path=pot,
                                  list_mode="sorted")
            sim.setup()
            p = sim.nl.params
            for dtype in (torch.float32, torch.float64):
                tag = f"{size} {str(dtype).split('.')[-1]}"
                entry = {"grid": list(p.ncells), "cc": p.cell_cap}
                for sweep, (ref, calls) in sweep_calls(
                        sim, dtype, old, other, fused).items():
                    errs = {k: _check(f"{tag} {sweep} {k}", fn(), ref,
                                      dtype) for k, fn in calls.items()}
                    ms = device_times(calls, rounds, inner)
                    entry[sweep] = {"ms": ms, "max_abs_err": errs}
                    say(f"[{tag} {sweep}] grid {p.ncells} x cc {p.cell_cap},"
                        " device ms per call: " + ", ".join(
                            f"{k} {v:.4f}" for k, v in ms.items())
                        + f", new / parent {ms['new'] / ms['parent']:.3f}")
                results[tag] = entry
            del sim
            torch.cuda.empty_cache()
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with an earlier tree's eam_cell.cu and "
                         "the headers it includes")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--inner", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args()
    main(args.parent, args.rounds, args.inner, args.out)
