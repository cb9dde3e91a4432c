"""The Newton-half plane kernels against an earlier tree's and against
the other designs of their reactions, in turns on the same inputs, on the
card.

The kernels are `csrc/lj_plane_half.cu`'s two instances: K8 (reactions,
`ops/half_kernels.lj_plane_half_force`) and P10 (forward sums only,
`lj_plane_half_fwd`). `--parent DIR` names a directory holding an earlier
tree's `lj_plane_half.cu` and the headers it includes; it is built beside
this tree's (ops/cuda_build, one nvcc each, all started together) and
launched through its own C entry points (before the walk: with the
reaction buffer its fold reads; on the walk, `on_walk`: as this tree's).
The other designs of K8's reactions (VARIANTS below) are this
tree's source with its reaction policy or its landing of the sums
replaced, each built in a temporary directory: "shared_atomics",
"rotated", "transposed" and "planes" compute K8 and are held to its
twin.
`lj_cell_force`, the full stencil, runs on the same inputs: the line a
Newton-half pass has to beat. The SASS of each K8 build is read for its
atomic and reduction instructions (cuobjdump).

Inputs: the bench/in.lj melt (`presets.lj_melt_sim`, seed 87287) at
cells 20 (32,000 atoms) and 63 (1,000,188 atoms), the sorted planes of
prof/grid with real rows jittered by a seeded +-0.05, f32 and f64; and the
1M deck's own positions after `run(200)` (f32). Every contender is first
held against its plain twin (f32 rtol 1e-4, f64
1e-10, atol rtol * max: the reactions sum in another order), then timed
by its device time per call (torch.profiler's summed device-op time of
`inner` calls, the output's zeroing included where a design needs it),
the contenders in turns, the median of `rounds`. K8 and lj_cell_force can
differ by a pair at the cutoff across the periodic box, whose shifted
coordinate the two stencils round in opposite frames: each is held to its
own twin, and the components where the two differ are counted beside
those where their twins do.

Run on the card, from the repository root:
  python -m lammps_kokkos_port_tpu_torch.prof.half_redesign --parent DIR
      [--rounds 5] [--inner 20] [--out results.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops import half_kernels as hk
from ..ops import pair_kernels
from ..presets import lj_melt_sim
from .grid import sorted_planes
from .redesign import (SEED, card, check, device_times, jittered,
                       parent_library, registers)
from .timing import say

_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the entry points of a tree before the walk: fx, fy, fz and the reaction
# buffer; of this tree and any on the walk (`on_walk`): one output
PARENT_ARGTYPES = {stem: [_PTR] * 9 + [_I32] * 4 + [_F64] * 4 + [_PTR]
                   for stem in ("lj_plane_half", "lj_plane_half_fwd")}
NEW_ARGTYPES = {stem: [_PTR] * 6 + [_I32] * 4 + [_F64] * 4 + [_PTR]
                for stem in ("lj_plane_half", "lj_plane_half_fwd")}
JITTER = 0.05
DECK_STEPS = 200

# The other designs of K8's reactions, each built from a copy of this
# tree's lj_plane_half.cu with a struct replaced: its `Reactions` policy
# (this tree's: each pair's reaction straight onto the candidate's row,
# through `Landing`), or its `Landing` (where a sum lands); in a copy of
# the headers whose walk also calls the policy's start(sm) before a row
# pass and flush(...) with every lane after each batch's passes
# (WALK_HOOKS).
#
# (a) "shared_atomics": a per-warp accumulator of the batch's kept
# candidates in shared memory (static, beside the walk's), one shared
# atomic per pair and component in pass 2, and after the batch one landed
# sum per kept candidate with a reaction.
SHARED_ATOMICS = r"""template <typename T> struct Reactions : Landing<T> {
  static constexpr bool kOn = true;

  template <typename S> static __device__ T* area() {
    __shared__ T r[cell_walk::kWarpsPerBlock * 3 * S::kSlots];
    return r + threadIdx.y * 3 * S::kSlots;
  }

  template <typename S> __device__ void start(const S&) const {
    T* r = area<S>();
    for (int i = threadIdx.x; i < 3 * S::kSlots; i += cell_walk::kTile)
      r[i] = T(0);
    __syncwarp();
  }

  template <typename B, typename S>
  __device__ void pair(const S&, int slot, const T (&d)[3], T f) const {
    T* r = area<S>();
#pragma unroll
    for (int a = 0; a < 3; ++a)
      atomicAdd(r + a * S::kSlots + slot, -B::part(d, f, a));
  }

  template <typename G, typename B, typename S>
  __device__ void flush(const G&, const B&, const Cand<T>&, bool,
                        const S& sm, int nb) const {
    const int lane = threadIdx.x;
    T* r = area<S>();
    const int* rows = sm.rows();
    const int* bounds = sm.bounds();
    __syncwarp();
    for (int g = 0; g < nb; ++g) {
      const int slot = g * cell_walk::kTile + lane;
      if (lane >= bounds[g]) continue;
      const T v[3] = {r[slot], r[S::kSlots + slot], r[2 * S::kSlots + slot]};
      if (v[0] != T(0) || v[1] != T(0) || v[2] != T(0)) {
        this->add(rows[slot], v[0], v[1], v[2]);
#pragma unroll
        for (int a = 0; a < 3; ++a) r[a * S::kSlots + slot] = T(0);
      }
    }
    __syncwarp();
  }
};
"""

# (b) "rotated": no atomic per pair inside the cutoff. Pass 2 keeps the
# forward sums; after it, a lane-rotated pass over each tile's pass-1 masks
# (at step k lane i takes candidate (i + k) mod 32 where its bit is set)
# recomputes the pair and moves -fij to the candidate's lane by one shuffle
# per component, where it is summed in a register in a fixed order; then
# one landed sum per candidate. The steps are those where any lane is
# inside the cutoff.
ROTATED = r"""template <typename T> struct Reactions : Landing<T> {
  static constexpr bool kOn = true;

  template <typename S> __device__ void start(const S&) const {}

  template <typename B, typename S>
  __device__ void pair(const S&, int, const T (&)[3], T) const {}

  template <typename G, typename B, typename S>
  __device__ void flush(const G& geo, const B& body, const Cand<T>& own,
                        bool live, const S& sm, int nb) const {
    const int lane = threadIdx.x;
    const unsigned* masks = sm.masks();
    const int* rows = sm.rows();
    const int* bounds = sm.bounds();
    __syncwarp();
    for (int g = 0; g < nb; ++g) {
      const int base = g * cell_walk::kTile;
      const unsigned m = live ? masks[base + lane] : 0u;
      const unsigned rot = __funnelshift_r(m, m, lane);
      unsigned steps = __reduce_or_sync(0xffffffffu, rot);
      T r[3] = {T(0), T(0), T(0)};
      while (steps != 0) {
        const int k = __ffs(steps) - 1;
        steps &= steps - 1;
        T p[3] = {T(0), T(0), T(0)};
        if (rot >> k & 1u) {
          const Cand<T> c = sm.get(base + ((lane + k) & 31));
          T d[3];
          const T r2 = geo.dist(own, c, d[0], d[1], d[2]);
          const T f = body.term(own, c, r2);
#pragma unroll
          for (int a = 0; a < 3; ++a) p[a] = B::part(d, f, a);
        }
#pragma unroll
        for (int a = 0; a < 3; ++a)
          r[a] -= __shfl_sync(0xffffffffu, p[a], (lane - k) & 31);
      }
      if (lane < bounds[g] &&
          (r[0] != T(0) || r[1] != T(0) || r[2] != T(0)))
        this->add(rows[base + lane], r[0], r[1], r[2]);
    }
    __syncwarp();
  }
};
"""

# (d) "transposed": no atomic per pair. After pass 2 each tile's masks are
# transposed by ballots, so lane j holds the own rows that pair with its
# candidate j; lane j walks that list, takes each own row's record by
# shuffles, recomputes the pair as pass 2 computed it and sums the
# reaction in a register in a fixed order; then one landed sum per
# candidate.
TRANSPOSED = r"""template <typename T> struct Reactions : Landing<T> {
  static constexpr bool kOn = true;

  template <typename S> __device__ void start(const S&) const {}

  template <typename B, typename S>
  __device__ void pair(const S&, int, const T (&)[3], T) const {}

  template <typename G, typename B, typename S>
  __device__ void flush(const G& geo, const B& body, const Cand<T>& own,
                        bool live, const S& sm, int nb) const {
    const int lane = threadIdx.x;
    const unsigned* masks = sm.masks();
    const int* rows = sm.rows();
    const int* bounds = sm.bounds();
    __syncwarp();
    for (int g = 0; g < nb; ++g) {
      const int base = g * cell_walk::kTile;
      const int n = bounds[g];
      if (n == 0) continue;
      const unsigned m = live ? masks[base + lane] : 0u;
      unsigned col = 0;
      for (int j = 0; j < n; ++j) {
        const unsigned b = __ballot_sync(0xffffffffu, m >> j & 1u);
        if (lane == j) col = b;
      }
      const Cand<T> c = sm.get(base + min(lane, n - 1));
      T r[3] = {T(0), T(0), T(0)};
      while (__any_sync(0xffffffffu, col != 0)) {
        const bool has = col != 0;
        const int i = has ? __ffs(col) - 1 : lane;
        col &= col - 1;
        const Cand<T> o = {__shfl_sync(0xffffffffu, own.x, i),
                           __shfl_sync(0xffffffffu, own.y, i),
                           __shfl_sync(0xffffffffu, own.z, i),
                           __shfl_sync(0xffffffffu, own.w, i)};
        if (has) {
          T d[3];
          const T r2 = geo.dist(o, c, d[0], d[1], d[2]);
          const T f = body.term(o, c, r2);
#pragma unroll
          for (int a = 0; a < 3; ++a) r[a] -= B::part(d, f, a);
        }
      }
      if (lane < n && (r[0] != T(0) || r[1] != T(0) || r[2] != T(0)))
        this->add(rows[base + lane], r[0], r[1], r[2]);
    }
    __syncwarp();
  }
};
"""

# (c) "planes": this tree's reactions landed in three planes [3, rows] in
# both types, one reduction per component, in place of f32's four-wide one
# into an interleaved output.
PLANES = r"""template <typename T> struct Landing {
  T* out;
  int rows;

  __device__ void add(int row, T x, T y, T z) const {
    atomicAdd(out + row, x);
    atomicAdd(out + rows + row, y);
    atomicAdd(out + 2 * rows + row, z);
  }
};
"""

# the walk's hooks for the variants: start before a row pass's walk, and
# flush with every lane after each batch's passes
WALK_HOOKS = (
    ("  const Box<T> box = own_box(own, live);\n",
     "  const Box<T> box = own_box(own, live);\n"
     "  if constexpr (R::kOn) react.start(sm);\n"),
    ("    if (!live) continue;\n"
     "    batch_passes(geo, body, own, t0, nb, self_tile, self_bit, cutsq, "
     "sm, acc,\n                 react);\n",
     "    if (live)\n"
     "      batch_passes(geo, body, own, t0, nb, self_tile, self_bit, cutsq, "
     "sm,\n                   acc, react);\n"
     "    if constexpr (R::kOn) react.flush(geo, body, own, live, sm, nb);\n"))

_EMPTY_HOOKS = """
  template <typename S> __device__ void start(const S&) const {}

  template <typename G, typename B, typename S>
  __device__ void flush(const G&, const B&, const Cand<T>&, bool, const S&,
                        int) const {}
};
"""


def _hooked(policy: str) -> str:
    """A policy with empty start and flush hooks."""
    return policy[:-len("};\n")] + _EMPTY_HOOKS


# name: ({struct: its text from this tree's}, whether it lands in three
# planes in f32 as in f64)
VARIANTS = {
    "shared_atomics": ({"Reactions": lambda _: SHARED_ATOMICS}, False),
    "rotated": ({"Reactions": lambda _: ROTATED}, False),
    "transposed": ({"Reactions": lambda _: TRANSPOSED}, False),
    "planes": ({"Reactions": _hooked, "Landing": lambda _: PLANES}, True)}


def _struct(text: str, name: str) -> str:
    """The definition of `template <typename T> struct name` in `text`."""
    found = re.findall(rf"template <typename T> struct {name}\b[^{{]*\{{"
                       r".*?\n\};\n", text, re.S)
    if len(found) != 1:
        raise RuntimeError(f"no single struct {name} in lj_plane_half.cu")
    return found[0]


def variant_source(dest: Path, edits: dict) -> Path:
    """This tree's lj_plane_half.cu and headers copied into `dest`, the
    walk with WALK_HOOKS and each struct of `edits` replaced by
    edits[name](its text)."""
    dest.mkdir(parents=True, exist_ok=True)
    for src in cuda_build.CSRC.glob("*.cuh"):
        text = src.read_text()
        if src.name == "cell_walk.cuh":
            for old, new in WALK_HOOKS:
                if text.count(old) != 1:
                    raise RuntimeError(f"cell_walk.cuh: no single {old!r}")
                text = text.replace(old, new)
        (dest / src.name).write_text(text)
    text = hk.SOURCE.read_text()
    for name, make in edits.items():
        old = _struct(text, name)
        text = text.replace(old, make(old))
    out = dest / hk.SOURCE.name
    out.write_text(text)
    return out


def on_walk(source: Path) -> bool:
    """Whether a tree's lj_plane_half.cu has this tree's entry points
    (the walk's: one output, and a launch-shape entry)."""
    return "lj_plane_half_shape" in source.read_text()


def half_calls(sp, parent, variants: dict, parent_walks: bool) -> dict:
    """The contenders on the planes `sp`: {"K8": {name: (call, twin)},
    "P10": {...}}; every call returns three force planes, `twin` is the
    plain result it is held to. `parent_walks`: the parent has this tree's
    entry points (`on_walk`)."""
    key, prd, cap = sp.key, sp.prd, sp.cap
    _, lj1, lj2, cutsq = key
    nx, ny, nz = sp.ncells
    flat = sp.flat
    ncell, cc = flat[0].shape
    sfx = "f32" if sp.buf.dtype == torch.float32 else "f64"
    args = (key, sp.ncells, cap, *sp.plane, prd)
    full = (key, sp.ncells, *flat[:3], prd)
    out = torch.empty((3, ncell, cc), dtype=sp.buf.dtype, device=prd.device)
    rbuf = torch.empty((ncell, len(hk.HALF) - 1, 3, cc), dtype=sp.buf.dtype,
                       device=prd.device)
    ptrs = [a.data_ptr() for a in (*flat, prd)]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def parent_call(stem):
        fn = getattr(parent, f"{stem}_{sfx}")

        def run():
            if parent_walks:  # one output: K8 adds into zeros
                buf, f = hk.output(ncell * cc, out.dtype, out.device,
                                   stem == "lj_plane_half")
                ptrs_out = (buf.data_ptr(),)
            else:
                f = out
                ptrs_out = (out[0].data_ptr(), out[1].data_ptr(),
                            out[2].data_ptr(), rbuf.data_ptr())
            if fn(*ptrs, *ptrs_out, nx, ny, nz, cc, float(cap), lj1, lj2,
                  cutsq, stream()) != 0:
                raise RuntimeError(f"parent {stem} launch failed")
            return f
        return run

    def variant_call(name, lib):
        fn = getattr(lib, f"lj_plane_half_{sfx}")
        planes = VARIANTS[name][1]

        def run():
            if planes:
                buf = torch.zeros_like(out)  # the design adds into zeros
                f = buf.unbind(0)
            else:
                buf, f = hk.output(ncell * cc, out.dtype, out.device, True)
            if fn(*ptrs, buf.data_ptr(), nx, ny, nz, cc, float(cap), lj1,
                  lj2, cutsq, stream()) != 0:
                raise RuntimeError(f"{name} lj_plane_half launch failed")
            return f
        return run

    k8 = hk.lj_plane_half_force_reference(*args)
    p10 = hk.lj_plane_half_fwd_reference(*args)
    return {
        "K8": {"parent": (parent_call("lj_plane_half"), k8),
               "new": (lambda: hk.lj_plane_half_force(*args), k8),
               **{name: (variant_call(name, lib), k8)
                  for name, lib in variants.items()},
               "lj_cell_force": (
                   lambda: pair_kernels.lj_cell_force(*full),
                   pair_kernels.lj_cell_force_reference(*full))},
        "P10": {"parent": (parent_call("lj_plane_half_fwd"), p10),
                "new": (lambda: hk.lj_plane_half_fwd(*args), p10)}}


def _flat3(forces):
    return torch.stack([a.reshape(-1) for a in forces])


def measure(tag: str, sp, parent, variants, rounds: int, inner: int,
            parent_walks: bool = False) -> dict:
    """Check and time every contender on `sp`; say and return the line.
    Where K8 and lj_cell_force differ beyond the tolerance, say in how
    many components, and in how many their twins differ: a pair at the
    cutoff whose shifted coordinate the two stencils round in opposite
    frames."""
    entry = {"grid": list(sp.ncells), "cc": sp.cc}
    for kernel, contenders in half_calls(sp, parent, variants,
                                         parent_walks).items():
        errs = {k: check(f"{tag} {kernel} {k}", _flat3(fn()), _flat3(ref),
                         sp.buf.dtype)
                for k, (fn, ref) in contenders.items()}
        ms = device_times({k: fn for k, (fn, _) in contenders.items()},
                          rounds, inner)
        entry[kernel] = {"ms": ms, "max_abs_err": errs}
        if kernel == "K8":
            entry[kernel]["against lj_cell_force"] = _differ(
                contenders, sp.buf.dtype)
        say(f"[{tag} {kernel}] grid {sp.ncells} x cc {sp.cc}, device ms per "
            "call: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
            + f", new / parent {ms['new'] / ms['parent']:.3f}"
            + (f", new / lj_cell_force {ms['new'] / ms['lj_cell_force']:.3f}"
               ", components where new and lj_cell_force (their twins) "
               "differ beyond the tolerance: {} ({})".format(
                   *entry[kernel]["against lj_cell_force"])
               if kernel == "K8" else ""))
    return entry


def _differ(contenders: dict, dtype) -> tuple:
    """Components beyond rtol * (max + |value|) between K8 and
    lj_cell_force, and between their twins."""
    rtol = 1e-4 if dtype == torch.float32 else 1e-10

    def count(a, b):
        a, b = _flat3(a), _flat3(b)
        return int(((a - b).abs() > rtol * (b.abs().max() + b.abs())).sum())
    (new, k8), (full, lj) = contenders["new"], contenders["lj_cell_force"]
    return count(new(), full()), count(k8, lj)


def sass_ops(source: Path) -> list:
    """Per kernel of `source`'s library: its shared atomics and global
    atomics and reductions, counted in the SASS (cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(cuda_build.lib_path(source))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return [{op: len(re.findall(rf"\b{re.escape(op)}[ .]", part))
             for op in ("ATOMS", "ATOMG", "REDG")}
            for part in sass.split("Function : ")[1:]]


def main(parent: str, rounds: int = 5, inner: int = 20,
         out: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("half_redesign needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()
    say(smi)
    old_src = Path(parent) / hk.SOURCE.name
    with tempfile.TemporaryDirectory() as tmp:
        var_src = {name: variant_source(Path(tmp) / name, make)
                   for name, (make, _) in VARIANTS.items()}
        cuda_build.build(hk.SOURCE, old_src, *var_src.values(),
                         pair_kernels.SOURCE)
        walks = on_walk(old_src)
        old = parent_library(old_src,
                             NEW_ARGTYPES if walks else PARENT_ARGTYPES)
        libs = {name: parent_library(src, NEW_ARGTYPES)
                for name, src in var_src.items()}
        regs = {tree: registers(src) for tree, src in (
            ("parent", old_src), ("new", hk.SOURCE), *var_src.items(),
            ("lj_cell_force", pair_kernels.SOURCE))}
        say("[registers] ptxas, per kernel in build order: "
            + "; ".join(f"{k} {v}" for k, v in regs.items()))
        say("[sass] per kernel in build order: " + "; ".join(
            f"{tree} {sass_ops(src)}" for tree, src in (
                ("new", hk.SOURCE), *var_src.items())))
        results = {"device": smi, "rounds": rounds, "inner": inner,
                   "registers": regs}
        for cells, size in ((20, "32k"), (63, "1M")):
            sim = lj_melt_sim(cells=cells, t_init=1.44, seed=SEED,
                              dtype=torch.float32, device=dev)
            sim.setup()
            for dtype in (torch.float32, torch.float64):
                x = jittered(sim, dtype, JITTER)
                tag = f"{size} {'f32' if dtype == torch.float32 else 'f64'}"
                results[tag] = measure(tag, sorted_planes(sim, x, dtype),
                                       old, libs, rounds, inner, walks)
            if cells == 63:
                sim.run(DECK_STEPS, thermo_every=DECK_STEPS)
                tag = "1M deck f32"
                results[tag] = measure(tag, sorted_planes(sim), old, libs,
                                       rounds, inner, walks)
            del sim
            torch.cuda.empty_cache()
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with an earlier tree's lj_plane_half.cu"
                         " and the headers it includes")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--inner", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args()
    main(args.parent, args.rounds, args.inner, args.out)
