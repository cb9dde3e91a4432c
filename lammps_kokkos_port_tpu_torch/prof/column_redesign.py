"""The Newton-half column passes against an earlier tree's and against the
other designs of this tree's, in turns on the same inputs, on the card.

The passes are the 11 of `prof/column_half_kernels.SPECS` (P2, P3, P5, P8,
P11), all instances of `csrc/lj_column_half.cu`. `--parent DIR` names a
directory holding an earlier tree's `lj_column_half.cu` and the headers it
includes; it is built beside this tree's (ops/cuda_build, one nvcc each,
all started together) and launched through its own C entry point (pass
number, warp rows, fold flag, three force planes and the reaction buffer
its fold reads), at its default launch; a parent on the walk (whose
source has this tree's `ColumnGrid`: `on_walk`) through this tree's entry
points. The other designs (VARIANTS below) are this tree's source with
one line replaced, each built in a temporary directory and launched
through `column_half_kernels.launch`:
"target_planes" lands the folded target passes' reactions in three planes
(one reduction per component) in place of f32's four-wide reduction into
interleaved blocks; "batch9" stages 9 tiles a batch in place of 7. Each
is held to the same twin. K8 (`ops/half_kernels.lj_plane_half_force`,
`iso_full`'s function on the same buffer), P10 (`lj_plane_half_fwd`,
`iso_noreverse`'s) and `lj_cell_force`, the full stencil, run beside them.

Inputs: the bench/in.lj melt (`presets.lj_melt_sim`, seed 87287) at cells
20 (32,000 atoms): its sorted planes at setup ("32k setup", the entry
points' own input) and with real rows jittered by a seeded +-0.05
("32k"), f32 and f64; and at cells 63 (1,000,188 atoms) the jittered
planes in f32, for `iso_full` and `iso_batched` (and their parents and
designs) beside K8 and `lj_cell_force`. Every contender is first held
against its plain twin (f32 rtol 1e-4, f64 1e-10, atol rtol * scale, the
reactions sum in another order; the scale is the larger of max|twin| and
the max of the forward half sums, which the lattice at setup does not
cancel as it cancels the forces; `iso_noassembly` must give NaN in every
output), then timed by its device time per call (torch.profiler's summed
device-op time of `inner` calls, the outputs' zeroing and the fold
included, traces checked for lost records: `prof/redesign.device_times`),
the contenders in turns, the median of `rounds`.

Run on the card, from the repository root:
  python -m lammps_kokkos_port_tpu_torch.prof.column_redesign --parent DIR
      [--rounds 5] [--inner 20] [--out results.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops import half_kernels as hk
from ..ops import pair_kernels
from ..presets import lj_melt_sim
from . import column_half_kernels as chk
from .grid import sorted_planes
from .redesign import (SEED, card, device_times, jittered, parent_library,
                       registers)
from .timing import say

_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the earlier tree's entry point: pass, warp rows, fold flag, inputs, three
# force planes and the reaction buffer
PARENT_ARGTYPES = {"lj_column_half": [_I32] * 3 + [_PTR] * 9 + [_I32] * 4
                   + [_F64] * 4 + [_PTR]}
# its pass numbers and reaction buffers: "cell" 13 x 3 x cc per cell,
# "target" rc [nx*ny, 3, nz, 5*cc], None: none
PARENT_PASSES = {
    "iso_full": (0, "cell"), "iso_batched": (1, "target"),
    "iso_redonly": (2, None), "iso_noreverse": (3, None),
    "iso_noassembly": (4, "cell"), "writeonce": (1, "target"),
    "halfv2": (5, "target"), "halfv2_approx": (6, "target"),
    "zchunk_fwd": (3, None), "zchunk_fused": (7, None),
    "cc32_half": (8, "cell")}
JITTER = 0.05
# the passes timed at 1M, and those whose launches a design changes
AT_1M = ("iso_full", "iso_batched")
TARGET_PASSES = ("iso_batched", "halfv2", "halfv2_approx")

# The other designs: (the line of this tree's lj_column_half.cu replaced,
# its replacement, the passes timed, in f32 only)
VARIANTS = {
    "target_planes": ("constexpr bool kFourWideTargets = true;",
                      "constexpr bool kFourWideTargets = false;",
                      TARGET_PASSES),
    "batch9": ("  static constexpr int kBatch = 7;",
               "  static constexpr int kBatch = 9;", tuple(chk.SPECS)),
}


def variant_source(dest: Path, old: str, new: str) -> Path:
    """This tree's lj_column_half.cu and headers copied into `dest`, the
    line `old` (found once) replaced by `new`."""
    dest.mkdir(parents=True, exist_ok=True)
    for src in cuda_build.CSRC.glob("*.cuh"):
        (dest / src.name).write_text(src.read_text())
    text = chk.SOURCE.read_text()
    if text.count(old + "\n") != 1:
        raise RuntimeError(f"lj_column_half.cu: no single line {old!r}")
    out = dest / chk.SOURCE.name
    out.write_text(text.replace(old + "\n", new + "\n"))
    return out


def _parent_call(lib, name, sp):
    """A call of the earlier tree's pass `name` on the planes `sp`:
    returns its three force planes (and its rc for writeonce)."""
    number, buf = PARENT_PASSES[name]
    key, prd, cap = sp.key, sp.prd, sp.cap
    _, lj1, lj2, cutsq = key
    nx, ny, nz = sp.ncells
    flat = sp.flat
    ncell, cc = flat[0].shape
    dt, dev = sp.buf.dtype, prd.device
    fn = getattr(lib, "lj_column_half_"
                 + ("f32" if dt == torch.float32 else "f64"))
    out = torch.empty((3, ncell, cc), dtype=dt, device=dev)
    if buf == "cell":
        rbuf = torch.empty((ncell, len(hk.HALF) - 1, 3, cc), dtype=dt,
                           device=dev)
    elif buf == "target":
        rbuf = torch.empty((nx * ny, 3, nz, len(hk.TARGETS) * cc),
                           dtype=dt, device=dev)
    else:
        rbuf = out  # not read
    rows = min(nz, 1024 // (-(-cc // 32) * 32))  # its default warp rows
    ptrs = [a.data_ptr() for a in (*flat, prd)]

    def run():
        if fn(number, rows, int(name != "writeonce"), *ptrs,
              out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
              rbuf.data_ptr(), nx, ny, nz, cc, float(cap), lj1, lj2, cutsq,
              torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError(f"parent {name} launch failed")
        return (*out, rbuf) if name == "writeonce" else tuple(out)
    return run


def on_walk(source: Path) -> bool:
    """Whether a tree's lj_column_half.cu has this tree's entry points (the
    walk's `ColumnGrid`)."""
    return "struct ColumnGrid" in source.read_text()


def calls(sp, parent, libs: dict, at_1m: bool,
          parent_walks: bool = False) -> dict:
    """The contenders on the planes `sp`: {label: (call, its plain
    twin's result)}; every call returns three force planes (and rc for
    writeonce). A parent on the walk (`parent_walks`) is launched through
    this tree's entry points, as the designs are."""
    args = (sp.key, sp.ncells, sp.cap, *sp.col, sp.prd)
    plane = (sp.key, sp.ncells, sp.cap, *sp.plane, sp.prd)
    full = (sp.key, sp.ncells, *sp.flat[:3], sp.prd)
    f32 = sp.buf.dtype == torch.float32
    names = AT_1M if at_1m else tuple(chk.SPECS)
    out = {}
    for name in names:
        ref = chk.reference(name, *args)
        if parent_walks:
            out[f"{name} parent"] = (
                lambda n=name: chk.launch(n, sp.key, sp.ncells, sp.cap,
                                          sp.flat, sp.prd, lib=parent), ref)
        else:
            out[f"{name} parent"] = (_parent_call(parent, name, sp), ref)
        out[f"{name} new"] = (lambda n=name: chk.PASSES[n](*args), ref)
        for var, lib in libs.items():
            if f32 and name in VARIANTS[var][2]:
                out[f"{name} {var}"] = (
                    lambda n=name, lib=lib: chk.launch(
                        n, sp.key, sp.ncells, sp.cap, sp.flat, sp.prd,
                        lib=lib), ref)
    out["K8"] = (lambda: hk.lj_plane_half_force(*plane),
                 hk.lj_plane_half_force_reference(*plane))
    if not at_1m:
        out["P10"] = (lambda: hk.lj_plane_half_fwd(*plane),
                      hk.lj_plane_half_fwd_reference(*plane))
    out["lj_cell_force"] = (lambda: pair_kernels.lj_cell_force(*full),
                            pair_kernels.lj_cell_force_reference(*full))
    return out


def _flat(forces) -> torch.Tensor:
    return torch.stack([a.reshape(-1) for a in forces])


def check_pass(label: str, got, ref, dtype, scale: float) -> float:
    """got within rtol * (scale + |ref|) of ref (f32 rtol 1e-4, f64
    1e-10) in every component, rc too for writeonce; the max abs error.
    A reference of NaN (noassembly) needs NaN in every output."""
    torch.cuda.synchronize()
    if all(bool(r.isnan().all()) for r in ref):
        if not all(bool(a.isnan().all()) for a in got):
            raise RuntimeError(f"{label}: not every output NaN")
        return 0.0
    rtol = 1e-4 if dtype == torch.float32 else 1e-10
    err = 0.0
    pairs = [(_flat(got[:3]), _flat(ref[:3]))]
    if len(ref) == 4:  # writeonce's rc
        pairs.append((got[3].reshape(-1), ref[3].reshape(-1)))
    for a, b in pairs:
        diff = (a - b).abs()
        bad = int((diff > rtol * scale + rtol * b.abs()).sum())
        if bad or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{label}: {bad} values out of tolerance")
        err = max(err, diff.max().item())
    return err


def measure(tag: str, sp, parent, libs: dict, rounds: int, inner: int,
            at_1m: bool = False, parent_walks: bool = False) -> dict:
    """Check and time every contender on `sp`; say and return the line."""
    dt = sp.buf.dtype
    contenders = calls(sp, parent, libs, at_1m, parent_walks)
    fwd = chk.reference("iso_noreverse", sp.key, sp.ncells, sp.cap,
                        *sp.col, sp.prd)
    scale = max(a.abs().max().item() for a in fwd)
    errs = {}
    for label, (fn, ref) in contenders.items():
        ref_max = [a.abs().max().item() for a in ref[:3]
                   if not bool(a.isnan().any())]
        errs[label] = check_pass(f"{tag} {label}", fn(), ref, dt,
                                 max([scale, *ref_max]))
    ms = device_times({k: fn for k, (fn, _) in contenders.items()},
                      rounds, inner)
    entry = {"grid": list(sp.ncells), "cc": sp.cc, "ms": ms,
             "max_abs_err": errs}
    ratios = {}
    for name in (AT_1M if at_1m else chk.SPECS):
        ratios[name] = ms[f"{name} new"] / ms[f"{name} parent"]
    entry["new / parent"] = ratios
    entry["iso_full / K8"] = ms["iso_full new"] / ms["K8"]
    say(f"[{tag}] grid {sp.ncells} x cc {sp.cc}, device ms per call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    say(f"[{tag}] new / parent: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ratios.items())
        + f"; iso_full / K8 {entry['iso_full / K8']:.3f}")
    return entry


def main(parent: str, rounds: int = 5, inner: int = 20,
         out: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("column_redesign needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()
    say(smi)
    old_src = Path(parent) / chk.SOURCE.name
    with tempfile.TemporaryDirectory() as tmp:
        var_src = {name: variant_source(Path(tmp) / name, old, new)
                   for name, (old, new, _) in VARIANTS.items()}
        cuda_build.build(chk.SOURCE, old_src, *var_src.values(), hk.SOURCE,
                         pair_kernels.SOURCE)
        walks = on_walk(old_src)
        old = (chk.bind(cuda_build.load(old_src)) if walks
               else parent_library(old_src, PARENT_ARGTYPES))
        libs = {name: chk.bind(cuda_build.load(src))
                for name, src in var_src.items()}
        # each build's own log (the sources share one file name)
        regs = {tree: chk.instance_registers(
            cuda_build.lib_path(src).with_suffix(".log").read_text())
            for tree, src in (("new", chk.SOURCE), *var_src.items())}
        regs["parent"] = registers(old_src)
        for tree, v in regs.items():
            say(f"[registers] {tree}, ptxas per kernel in build order: "
                + "; ".join(f"{r[0]} {r[1]}" if isinstance(r, tuple)
                            else str(r) for r in v))
        results = {"device": smi, "rounds": rounds, "inner": inner,
                   "registers": regs}
        sim = lj_melt_sim(cells=20, t_init=1.44, seed=SEED,
                          dtype=torch.float32, device=dev)
        sim.setup()
        for dtype in (torch.float32, torch.float64):
            sfx = "f32" if dtype == torch.float32 else "f64"
            results[f"32k setup {sfx}"] = measure(
                f"32k setup {sfx}", sorted_planes(sim, dtype=dtype), old,
                libs, rounds, inner, parent_walks=walks)
            results[f"32k {sfx}"] = measure(
                f"32k {sfx}", sorted_planes(sim, jittered(sim, dtype, JITTER),
                                            dtype), old, libs, rounds, inner,
                parent_walks=walks)
        del sim
        sim = lj_melt_sim(cells=63, t_init=1.44, seed=SEED,
                          dtype=torch.float32, device=dev)
        sim.setup()
        results["1M f32"] = measure(
            "1M f32", sorted_planes(sim, jittered(sim, torch.float32,
                                                  JITTER), torch.float32),
            old, libs, rounds, inner, at_1m=True, parent_walks=walks)
        del sim
        torch.cuda.empty_cache()
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with an earlier tree's lj_column_half.cu"
                         " and the headers it includes")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--inner", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args()
    main(args.parent, args.rounds, args.inner, args.out)
