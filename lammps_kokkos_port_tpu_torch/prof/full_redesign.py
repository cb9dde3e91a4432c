"""K7, P6 k1 and k2 (csrc/lj_column_full.cu), the P9 and P4 ablations
(csrc/lj_ablate.cu) and lj_cell_force against an earlier tree's, in turns
on the same inputs, on the card.

`--parent DIR` names a directory holding an earlier tree's
`lj_column_full.cu`, `lj_ablate.cu`, `lj_cell_force.cu` and the headers
they include; they are built beside this tree's (ops/cuda_build, one nvcc
each, all started together) and launched through their own C entry
points, which take the same arguments in both trees (PARENT_ENTRIES),
each at the launch its tree makes. The other design (VARIANTS) is this
tree's `lj_ablate.cu` with one line replaced, built in a temporary
directory and launched through `ablate_kernels`' entry points: "split8"
gives each row 8 threads in place of 4.

Inputs: the bench/in.lj melt (`presets.lj_melt_sim`, seed 87287) at
cells 20 (32,000 atoms, grid (12, 12, 12) x cc 32): its sorted planes at
setup ("32k setup", the entry points' own input) and with real rows
jittered by a seeded +-0.05 ("32k"), f32 and f64, for K7, k1, k2 and
lj_cell_force; at cells 63 (1,000,188 atoms) the jittered planes in f32
for K7, k1 and lj_cell_force. The pair ablations (`pair_only`,
`pair_only_approx`, P4 = `pair_only` at 512 lanes) and `asm_only` run on
the melt's setup planes (their timed inputs; no row there needs pair
math) and `pair_only` and P4 on the live inputs of chip_smoke.py's phases
13 and 16 (positions 3 +- [0.8, 1.6] per axis, ids -1..2), f32 (f64:
`pair_only` and P4). `pair_only` also runs at 896 lanes on the setup
planes: the ablation runs the body on every lane, so its time must grow
with the lanes (`new 896 / new 448`, at least LANE_RATIO_MIN).

Every contender is first held against its plain twin (f32 rtol 1e-4,
f64 1e-10, atol rtol * scale; `asm_only` exactly; the scale is max|twin|
or, for the column passes, the larger of that and the max of the
Newton-half forward sums on the same planes, which the lattice at setup
does not cancel as it cancels the forces), then timed by its
device time per call (torch.profiler's summed device-op time of `inner`
calls, traces checked for lost records: `prof/redesign.device_times`),
the contenders in turns, the median of `rounds`.

Run on the card, from the repository root:
  python -m lammps_kokkos_port_tpu_torch.prof.full_redesign --parent DIR
      [--rounds 5] [--inner 20] [--out results.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import tempfile
from pathlib import Path

import torch

from ..ops import column_kernels as ck
from ..ops import cuda_build, pair_kernels
from ..presets import lj_melt_sim
from . import ablate_kernels as ak
from . import column_half_kernels as chk
from . import v3_kernels as v3k
from .grid import sorted_planes
from .redesign import SEED, card, device_times, jittered, registers
from .timing import say

_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_COLUMN = [_PTR] * 8 + [_I32] * 4 + [_F64] * 3 + [_PTR]
_PAIR = [_PTR] * 7 + [_I32] * 3 + [_F64] * 4 + [_PTR]
# the earlier tree's entry points: {contender: (source, C stem, argtypes,
# dtypes it has)}
PARENT_ENTRIES = {
    "K7": ("lj_column_full.cu", "lj_column_full", _COLUMN, ("f32", "f64")),
    "k1": ("lj_column_full.cu", "lj_column_v3_k1", _COLUMN, ("f32", "f64")),
    "k2": ("lj_column_full.cu", "lj_column_v3_k2", _COLUMN, ("f32", "f64")),
    "pair_only": ("lj_ablate.cu", "lj_pair_only", _PAIR, ("f32", "f64")),
    "pair_only_approx": ("lj_ablate.cu", "lj_pair_only_approx", _PAIR,
                         ("f32",)),
    "P4": ("lj_ablate.cu", "lj_pair_only", _PAIR, ("f32", "f64")),
    "asm_only": ("lj_ablate.cu", "lj_asm_only",
                 [_PTR] * 8 + [_I32] * 4 + [_PTR], ("f32", "f64")),
    "lj_cell_force": ("lj_cell_force.cu", "lj_cell_force",
                      [_PTR] * 7 + [_I32] * 4 + [_F64] * 3 + [_PTR],
                      ("f32", "f64")),
}
SOURCES = {"lj_column_full.cu": ck.SOURCE, "lj_ablate.cu": ak.SOURCE,
           "lj_cell_force.cu": pair_kernels.SOURCE}
P4_LANES = 512
WIDE_LANES = 896  # twice the 14 * cc = 448 of the 32k melt
LANE_RATIO_MIN = 1.8
JITTER = 0.05
COLUMN = ("K7", "k1", "k2", "lj_cell_force")
AT_1M = ("K7", "k1", "lj_cell_force")
# The other design: (the line of this tree's lj_ablate.cu replaced, its
# replacement, the contenders timed with it)
VARIANTS = {"split8": ("constexpr int kSplit = 4;  // threads per row (a "
                       "power of two <= 32)",
                       "constexpr int kSplit = 8;",
                       ("pair_only", "pair_only_approx", "P4"))}


def parent_sources(parent, sources=None) -> dict:
    """{source name: the earlier tree's file} of `sources` (default
    SOURCES); raises unless `parent` is a directory holding every source
    and at least one header."""
    root = Path(parent)
    if not root.is_dir():
        raise FileNotFoundError(f"--parent {parent}: not a directory")
    out = {name: root / name for name in sources or SOURCES}
    missing = [name for name, p in out.items() if not p.is_file()]
    if missing or not any(root.glob("*.cuh")):
        raise FileNotFoundError(f"--parent {parent}: missing "
                                f"{missing or 'the *.cuh headers'}")
    return out


def check_counts(rounds: int, inner: int) -> None:
    if rounds < 1 or inner < 1:
        raise ValueError(f"rounds and inner must be >= 1, got {rounds}, "
                         f"{inner}")


def variant_source(dest: Path, old: str, new: str) -> Path:
    """This tree's lj_ablate.cu and headers copied into `dest`, the line
    `old` (found once) replaced by `new`."""
    dest.mkdir(parents=True, exist_ok=True)
    for src in cuda_build.CSRC.glob("*.cuh"):
        (dest / src.name).write_text(src.read_text())
    text = ak.SOURCE.read_text()
    if text.count(old + "\n") != 1:
        raise RuntimeError(f"lj_ablate.cu: no single line {old!r}")
    out = dest / ak.SOURCE.name
    out.write_text(text.replace(old + "\n", new + "\n"))
    return out


def bind_parent(paths: dict, entries=None) -> dict:
    """{contender: {"f32": fn, "f64": fn}} of the earlier tree's
    libraries, for the contenders of `entries` (default PARENT_ENTRIES)."""
    libs = {name: cuda_build.load(p) for name, p in paths.items()}
    out = {}
    for name, (src, stem, types, dts) in (entries or PARENT_ENTRIES).items():
        out[name] = {}
        for dt in dts:
            fn = getattr(libs[src], f"{stem}_{dt}")
            fn.argtypes = types
            fn.restype = ctypes.c_int
            out[name][dt] = fn
    return out


def bind_variant(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A variant's pair entry points, bound as ablate_kernels binds
    them."""
    for name in ("lj_pair_only_f32", "lj_pair_only_f64",
                 "lj_pair_only_approx_f32"):
        fn = getattr(lib, name)
        fn.argtypes = _PAIR
        fn.restype = ctypes.c_int
    return lib


def _sfx(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _column_parent(fn, sp):
    """A call of an earlier tree's column pass (K7, k1, k2) on `sp`."""
    _, lj1, lj2, cutsq = sp.key
    out = torch.empty((3, *sp.flat[0].shape), dtype=sp.buf.dtype,
                      device=sp.buf.device)
    ptrs = [a.data_ptr() for a in (*sp.flat, sp.prd, *out)]

    def run():
        if fn(*ptrs, *sp.ncells, sp.cc, lj1, lj2, cutsq, _stream()) != 0:
            raise RuntimeError("parent column pass launch failed")
        return tuple(out)
    return run


def _cell_parent(fn, sp):
    """A call of an earlier tree's lj_cell_force on `sp`."""
    _, lj1, lj2, cutsq = sp.key
    out = torch.empty((3, *sp.flat[0].shape), dtype=sp.buf.dtype,
                      device=sp.buf.device)
    ptrs = [a.data_ptr() for a in (*sp.flat[:3], sp.prd, *out)]

    def run():
        if fn(*ptrs, *sp.ncells, sp.cc, lj1, lj2, cutsq, _stream()) != 0:
            raise RuntimeError("parent lj_cell_force launch failed")
        return tuple(out)
    return run


def _pair_call(fn, key, flat, lanes):
    """A call of a pair_only entry point (an earlier tree's or a variant's)
    on the [ncell, cc] channels `flat`."""
    _, lj1, lj2, cutsq = key
    ncell, cc = flat[0].shape
    out = torch.empty((3, ncell, cc), dtype=flat[0].dtype,
                      device=flat[0].device)
    ptrs = [a.data_ptr() for a in (*flat, *out)]

    def run():
        if fn(*ptrs, ncell, cc, lanes, ak.FILL, lj1, lj2, cutsq,
              _stream()) != 0:
            raise RuntimeError("pair_only launch failed")
        return tuple(out)
    return run


def _asm_parent(fn, sp):
    out = torch.empty((3, *sp.flat[0].shape), dtype=sp.buf.dtype,
                      device=sp.buf.device)
    ptrs = [a.data_ptr() for a in (*sp.flat, sp.prd, *out)]

    def run():
        if fn(*ptrs, *sp.ncells, sp.cc, _stream()) != 0:
            raise RuntimeError("parent asm_only launch failed")
        return tuple(out)
    return run


def column_calls(sp, parent, names) -> dict:
    """{label: (call, its twin's result)} of the column contenders `names`
    and lj_cell_force on the planes `sp`, parent and new."""
    col = (sp.key, sp.ncells, *sp.col, sp.prd)
    full = (sp.key, sp.ncells, *sp.flat[:3], sp.prd)
    sfx = _sfx(sp.buf.dtype)
    new = {"K7": lambda: ck.lj_column_force(*col),
           "k1": lambda: v3k.v3_k1(*col), "k2": lambda: v3k.v3_k2(*col),
           "lj_cell_force": lambda: pair_kernels.lj_cell_force(*full)}
    twin = {"K7": lambda: ck.lj_column_force_reference(*col),
            "k1": lambda: v3k.v3_reference(*col),
            "k2": lambda: v3k.v3_reference(*col, grouped=True),
            "lj_cell_force": lambda: pair_kernels.lj_cell_force_reference(
                *full)}
    out = {}
    for name in names:
        ref = twin[name]()
        make = _cell_parent if name == "lj_cell_force" else _column_parent
        out[f"{name} parent"] = (make(parent[name][sfx], sp), ref)
        out[f"{name} new"] = (new[name], ref)
    return out


def live_inputs(sp, seed: int = SEED) -> tuple:
    """chip_smoke.py's live pair_only inputs on the grid of `sp`: positions
    3 +- [0.8, 1.6] per axis (seeded), ids -1..2 by row; [ncell, cc] each."""
    gen = torch.Generator(device=sp.buf.device).manual_seed(seed)
    flat = []
    for a in sp.flat[:3]:
        u = torch.rand(a.shape, generator=gen, device=a.device,
                       dtype=a.dtype)
        flat.append(3.0 + torch.where(u < 0.5, -1.0, 1.0) * (0.8 + 0.8 * u))
    gi = sp.flat[3]
    ids = torch.remainder(torch.arange(gi.numel(), device=gi.device),
                          4).to(gi.dtype).reshape(gi.shape) - 1
    return (*flat, ids)


def pair_calls(sp, flat, parent, variants, timed_inputs: bool) -> dict:
    """{label: (call, its twin's result)} of the pair ablations on the
    [ncell, cc] channels `flat` (grid of `sp`), parent, new and variants;
    with `timed_inputs` also asm_only and pair_only at WIDE_LANES."""
    dtype = flat[0].dtype
    sfx = _sfx(dtype)
    col = [a.reshape(sp.col[0].shape) for a in flat]
    args = (sp.ncells, *col, sp.prd)
    lanes = {"pair_only": None, "pair_only_approx": None, "P4": P4_LANES}
    if timed_inputs:
        lanes["pair_only 896"] = WIDE_LANES
    default = 14 * sp.cc
    out = {}
    for label, n in lanes.items():
        name = label.split()[0]
        if name == "pair_only_approx" and dtype != torch.float32:
            continue
        ref = ak.pair_only_reference(sp.key, *args, lanes=n)
        count = n or default
        entry = "lj_pair_only_approx" if name == "pair_only_approx" \
            else "lj_pair_only"
        parent_fn = parent["P4" if n == P4_LANES else name][sfx]
        out[f"{label} parent"] = (_pair_call(parent_fn, sp.key, flat, count),
                                  ref)
        if name == "pair_only_approx":
            out[f"{label} new"] = (
                lambda: ak.pair_only_approx(sp.key, *args), ref)
        else:
            out[f"{label} new"] = (
                lambda n=n: ak.pair_only(sp.key, *args, lanes=n), ref)
        for var, lib in variants.items():
            if name in VARIANTS[var][2]:
                out[f"{label} {var}"] = (_pair_call(
                    getattr(lib, f"{entry}_{sfx}"), sp.key, flat, count),
                    ref)
    if timed_inputs:
        ref = ak.asm_only_reference(*args)
        out["asm_only parent"] = (_asm_parent(parent["asm_only"][sfx], sp),
                                  ref)
        out["asm_only new"] = (lambda: ak.asm_only(*args), ref)
    return out


def force_scale(sp) -> float:
    """The column passes' scale on the planes `sp`: the max of the
    Newton-half forward sums (each pair once, not cancelled at setup)."""
    fwd = chk.reference("iso_noreverse", sp.key, sp.ncells, sp.cap, *sp.col,
                        sp.prd)
    return max(a.abs().max().item() for a in fwd)


def check_contender(label: str, got, ref, dtype, scale: float = 0.0) -> float:
    """got within rtol * (max(scale, max|ref|) + |ref|) of ref (f32 1e-4,
    f64 1e-10; asm_only exactly); the max abs error."""
    torch.cuda.synchronize()
    rtol = 0.0 if label.startswith("asm_only") else (
        1e-4 if dtype == torch.float32 else 1e-10)
    a = torch.stack([t.reshape(-1) for t in got])
    b = torch.stack([t.reshape(-1) for t in ref])
    err = (a - b).abs()
    vmax = max(scale, b.abs().max().item())
    bad = int((err > rtol * vmax + rtol * b.abs()).sum())
    if bad or not bool(torch.isfinite(a).all()):
        raise RuntimeError(f"{label}: {bad} values out of tolerance")
    return err.max().item()


def measure(tag: str, contenders: dict, dtype, rounds: int, inner: int,
            scale: float = 0.0) -> dict:
    """Check and time `contenders`; say and return the line."""
    errs = {label: check_contender(f"{tag} {label}", fn(), ref, dtype, scale)
            for label, (fn, ref) in contenders.items()}
    ms = device_times({k: fn for k, (fn, _) in contenders.items()}, rounds,
                      inner)
    ratios = {k[:-4]: ms[k] / ms[f"{k[:-4]} parent"] for k in ms
              if k.endswith(" new")}
    say(f"[{tag}] device ms per call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    say(f"[{tag}] new / parent: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    return {"ms": ms, "max_abs_err": errs, "new / parent": ratios}


def main(parent: str, rounds: int = 5, inner: int = 20,
         out: str | None = None) -> dict:
    check_counts(rounds, inner)
    old = parent_sources(parent)
    if not torch.cuda.is_available():
        raise RuntimeError("full_redesign needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()
    say(smi)
    with tempfile.TemporaryDirectory() as tmp:
        var_src = {name: variant_source(Path(tmp) / name, a, b)
                   for name, (a, b, _) in VARIANTS.items()}
        cuda_build.build(*SOURCES.values(), *old.values(), *var_src.values())
        parent_fns = bind_parent(old)
        variants = {name: bind_variant(cuda_build.load(src))
                    for name, src in var_src.items()}
        regs = {f"{name} {tree}": registers(p)
                for tree, paths in (("parent", old), ("new", SOURCES),
                                    *((v, {"lj_ablate.cu": s})
                                      for v, s in var_src.items()))
                for name, p in paths.items()}
        for k, v in regs.items():
            say(f"[registers] {k}, ptxas per kernel in build order: {v}")
        results = {"device": smi, "rounds": rounds, "inner": inner,
                   "registers": regs}

        sim = lj_melt_sim(cells=20, t_init=1.44, seed=SEED,
                          dtype=torch.float32, device=dev)
        sim.setup()
        for dtype in (torch.float32, torch.float64):
            sfx = _sfx(dtype)
            setup = sorted_planes(sim, dtype=dtype)
            jit = sorted_planes(sim, jittered(sim, dtype, JITTER), dtype)
            for tag, sp in ((f"32k setup {sfx}", setup), (f"32k {sfx}", jit)):
                results[tag] = measure(tag, column_calls(sp, parent_fns,
                                                         COLUMN),
                                       dtype, rounds, inner, force_scale(sp))
            tag = f"pair 32k setup {sfx}"
            results[tag] = measure(tag, pair_calls(
                setup, setup.flat, parent_fns, variants, True), dtype,
                rounds, inner)
            ms = results[tag]["ms"]
            ratio = {t: ms[f"pair_only 896 {t}"] / ms[f"pair_only {t}"]
                     for t in ("parent", "new", *variants)}
            results[tag]["lanes 896 / 448"] = ratio
            say(f"[{tag}] pair_only device time at {WIDE_LANES} lanes over "
                f"448: " + ", ".join(f"{k} {v:.3f}" for k, v in ratio.items())
                + f" (at least {LANE_RATIO_MIN} for the new design)")
            if ratio["new"] < LANE_RATIO_MIN:
                raise RuntimeError(f"pair_only: {ratio['new']:.3f} times the "
                                   f"time at twice the lanes")
            tag = f"pair 32k live {sfx}"
            results[tag] = measure(tag, pair_calls(
                setup, live_inputs(setup), parent_fns, variants, False),
                dtype, rounds, inner)
        del sim
        torch.cuda.empty_cache()
        sim = lj_melt_sim(cells=63, t_init=1.44, seed=SEED,
                          dtype=torch.float32, device=dev)
        sim.setup()
        sp = sorted_planes(sim, jittered(sim, torch.float32, JITTER),
                           torch.float32)
        del sim
        results["1M f32"] = measure("1M f32", column_calls(sp, parent_fns,
                                                           AT_1M),
                                    torch.float32, rounds, inner,
                                    force_scale(sp))
        torch.cuda.empty_cache()
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with an earlier tree's lj_column_full.cu,"
                         " lj_ablate.cu, lj_cell_force.cu and the headers "
                         "they include")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--inner", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args()
    main(args.parent, args.rounds, args.inner, args.out)
