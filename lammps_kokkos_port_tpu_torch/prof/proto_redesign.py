"""P12 (csrc/zwin_proto.cu) and P6 k2 (csrc/lj_column_full.cu, with k1,
K7 and lj_cell_force beside it) against an earlier tree's, in turns on the
same inputs, on the card.

`--parent DIR` names a directory holding an earlier tree's
`zwin_proto.cu`, `lj_column_full.cu`, `lj_cell_force.cu` and the headers
they include; they are built beside this tree's (ops/cuda_build, one nvcc
each, all started together) and launched through their own C entry points
(PARENT_ENTRIES). The column passes and `lj_cell_force` take the same
arguments in both trees; the earlier `zwin_proto_f32`, a pass and a fold,
also takes the pass's strips, [NCOL][3][own + 4 nb] floats
(`parent_strip_len`). The other designs of P12 (VARIANTS) are this tree's
`zwin_proto.cu` with its thread split replaced (threads per forward sum,
threads per reaction element), each built in a temporary directory and
launched through the same C entry point: "split 1" is one thread an
output, "split 8" eight, "fwd 4 rct 2" two threads a reaction element
(twice the positions a reaction block); "512 threads" doubles the block
(twice the chunks a forward block, twice the positions a reaction block);
"fwd first" puts the forward blocks first in the grid. The
ablations (ABLATIONS: the forward or the reaction blocks alone, each
also with its staging and no pair loop) are built alike and timed only:
their outputs are partial.

Inputs: P12 on the script's (`zwin_kernels.zwin_inputs`: ncol 144, S 256,
seed 0) and at ncol 1296 (a line that is reported, not a gate). K7, P6 k1
and k2 and `lj_cell_force` on full_redesign's planes: the bench/in.lj
melt (seed 87287) at cells 20 (32,000 atoms) at setup and with real rows
jittered by a seeded +-0.05, f32 and f64, and at cells 63 (1,000,188
atoms) jittered, f32.

Every contender is first held to its plain twin: P12 by the scaled check
(`zwin_kernels.max_scaled_error` within SCALED_LIMIT), and with every
window start moved by one it must fail that check (beyond PLANTED_MIN);
this tree's P12 must repeat bit for bit over two launches; the column
passes as full_redesign holds them (f32 rtol 1e-4, f64 1e-10, atol rtol *
scale). Then each is timed by its device time per call (torch.profiler's
summed device-op time of `inner` calls, traces checked for lost records:
`prof/redesign.device_times`), the contenders in turns, the median of
`rounds`.

Run on the card, from the repository root:
  python -m lammps_kokkos_port_tpu_torch.prof.proto_redesign --parent DIR
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
from . import full_redesign as fr
from . import zwin_kernels as zk
from .grid import sorted_planes
from .redesign import SEED, card, device_times, jittered, registers
from .timing import say

_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
COLUMN = ("K7", "k1", "k2", "lj_cell_force")
# the earlier tree's entry points: {contender: (source, C stem, argtypes,
# dtypes it has)}; its zwin_proto_f32 takes the strips after the outputs
PARENT_ENTRIES = {
    **{name: fr.PARENT_ENTRIES[name] for name in COLUMN},
    "P12": ("zwin_proto.cu", "zwin_proto",
            [_PTR] * 14 + [_I32] * 9 + [_F64] * 3 + [_PTR], ("f32",)),
}
SOURCES = {"zwin_proto.cu": zk.SOURCE, "lj_column_full.cu": ck.SOURCE,
           "lj_cell_force.cu": pair_kernels.SOURCE}
# this tree's zwin_proto.cu lines that the designs replace
FWD_SPLIT = ("constexpr int kFwdSplit = 4;  // threads per own atom (a "
             "power of two <= 32)")
RCT_SPLIT = ("constexpr int kRctSplit = 4;  // threads per reaction element "
             "(<= kOwn)")


def _splits(fwd: int, rct: int) -> tuple:
    return ((FWD_SPLIT, f"constexpr int kFwdSplit = {fwd};"),
            (RCT_SPLIT, f"constexpr int kRctSplit = {rct};"))


# The other designs of P12: {name: ((line, its replacement), ...)}
THREADS = ("constexpr int kThreads = 256;  // threads per block, both roles",
           "constexpr int kThreads = 512;")
VARIANTS = {"split 1": _splits(1, 1), "split 8": _splits(8, 8),
            "fwd 4 rct 2": _splits(4, 2), "512 threads": (THREADS,),
            "fwd first": (("  if (b < nrct)", "  if (b >= a.nfwd)"),
                          ("    reaction(a, b, zrec);",
                           "    reaction(a, b - a.nfwd, zrec);"),
                          ("    forward(a, b - nrct, zrec);",
                           "    forward(a, b, zrec);"))}
# Parts of this tree's launch, timed only (their outputs are partial): the
# forward blocks alone, the reaction blocks alone, and each with its
# blocks' staging and no pair loop
_GRID = "  const dim3 grid(a.nfwd + ncol * rct_per_col);"
_FWD = (_GRID, "  const dim3 grid(a.nfwd);")
_RCT = ((_GRID, "  const dim3 grid(ncol * rct_per_col);"),
        ("         rct_per_col, ncol * fwd_per_col,",
         "         rct_per_col, 0,"))
ABLATIONS = {
    "fwd only": (_FWD,),
    "fwd staging": (_FWD, ("  if (live) {", "  if (false) {")),
    "rct only": _RCT,
    "rct staging": (*_RCT, (
        "      for (int k = lo; k <= hi; ++k) {",
        "      for (int k = lo; k < lo; ++k) {")),
}
ZWIN_SHAPES = {"P12": zk.ZwinShape(), "P12 ncol 1296": zk.ZwinShape(
    ncol=1296)}
SCALED_LIMIT = 1e-4
PLANTED_MIN = 0.1


def parent_strip_len(shape) -> int:
    """The earlier tree's strips per column and component: the own strip
    (windows at 8k) and four neighbour strips (windows at k)."""
    return (zk.OWN * (shape.npc - 1) + shape.ws
            + 4 * (shape.npc - 1 + shape.wn))


def variant_source(dest: Path, lines) -> Path:
    """This tree's zwin_proto.cu and headers copied into `dest`, each line
    `old` of `lines` (found once) replaced by its `new`."""
    dest.mkdir(parents=True, exist_ok=True)
    for src in cuda_build.CSRC.glob("*.cuh"):
        (dest / src.name).write_text(src.read_text())
    text = zk.SOURCE.read_text()
    for old, new in lines:
        if text.count(old + "\n") != 1:
            raise RuntimeError(f"zwin_proto.cu: no single line {old!r}")
        text = text.replace(old + "\n", new + "\n")
    out = dest / zk.SOURCE.name
    out.write_text(text)
    return out


def bind_variant(lib: ctypes.CDLL):
    """A design's entry point, bound as zwin_kernels binds this tree's."""
    fn = lib.zwin_proto_f32
    fn.argtypes = [_PTR] * 13 + [_I32] * 9 + [_F64] * 3 + [_PTR]
    fn.restype = ctypes.c_int
    return fn


def zwin_call(fn, shape, inputs, strips: bool):
    """A call of a zwin_proto_f32 entry point (an earlier tree's, which
    takes `strips`, or a design's) on `inputs`; returns its six outputs
    (the same tensors at every call)."""
    dev = inputs[0].device
    out = [torch.empty_like(a) for a in (*inputs[3:6], *inputs[:3])]
    scratch = [torch.empty((shape.ncol, 3, parent_strip_len(shape)),
                           dtype=torch.float32, device=dev)] if strips else []
    ptrs = [a.data_ptr() for a in (*inputs, *out, *scratch)]

    def run():
        if fn(*ptrs, shape.ncol, shape.s, shape.g, shape.ws, shape.wn,
              *shape.offsets, zk.CUTSQ, zk.LJ1, zk.LJ2,
              torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("zwin_proto launch failed")
        return tuple(out)
    return run


def zwin_contenders(shape, inputs, parent, designs) -> dict:
    """{label: (call, the call on the starts moved by one)} of P12's
    parent, this tree's kernel and its designs (VARIANTS) on `inputs`."""
    moved = (*inputs[:-1], inputs[-1] + 1)
    out = {"parent": tuple(zwin_call(parent, shape, x, True)
                           for x in (inputs, moved)),
           "new": tuple((lambda x=x: zk.zwin_proto(*x, shape=shape))
                        for x in (inputs, moved))}
    for name, fn in designs.items():
        out[name] = tuple(zwin_call(fn, shape, x, False)
                          for x in (inputs, moved))
    return out


def zwin_measure(tag: str, shape, parent, designs, ablations,
                 rounds: int, inner: int) -> dict:
    """P12's contenders on the script's inputs at `shape`: each checked
    (scaled error, planted fault; this tree's two launches bit-equal),
    then timed with the `ablations` (not checked); says and returns the
    line."""
    inputs = zk.zwin_inputs(shape, device=torch.device("cuda", 0))
    ref = zk.zwin_reference(*inputs, shape=shape)
    scale = zk.zwin_reference(*inputs, shape=shape, magnitude=True)
    calls = zwin_contenders(shape, inputs, parent, designs)
    errs, planted = {}, {}
    for label, (run, run_moved) in calls.items():
        got = [a.clone() for a in run()]
        errs[label] = zk.max_scaled_error(got, ref, scale)
        planted[label] = zk.max_scaled_error(run_moved(), ref, scale)
        if not (all(bool(torch.isfinite(a).all()) for a in got)
                and errs[label] <= SCALED_LIMIT
                and planted[label] > PLANTED_MIN):
            raise RuntimeError(f"{tag} {label}: scaled error "
                               f"{errs[label]}, planted {planted[label]}")
        if label == "new" and not all(
                torch.equal(a, b) for a, b in zip(got, run())):
            raise RuntimeError(f"{tag}: two launches differ")
    parts = {name: zwin_call(fn, shape, inputs, False)
             for name, fn in ablations.items()}
    ms = device_times({**{k: v[0] for k, v in calls.items()}, **parts},
                      rounds, inner)
    ratios = {k: ms[k] / ms["parent"] for k in ms if k != "parent"}
    say(f"[{tag}] ncol {shape.ncol}, {shape.lane_pairs} lane-pairs; "
        "device ms per call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + "; scaled error " + ", ".join(f"{k} {v:.3g}"
                                         for k, v in errs.items())
        + "; with the starts moved by one " + ", ".join(
            f"{k} {v:.3g}" for k, v in planted.items()))
    say(f"[{tag}] over the parent: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    return {"ms": ms, "scaled_err": errs, "planted": planted,
            "over parent": ratios}


def main(parent: str, rounds: int = 5, inner: int = 20,
         out: str | None = None) -> dict:
    fr.check_counts(rounds, inner)
    old = fr.parent_sources(parent, SOURCES)
    if not torch.cuda.is_available():
        raise RuntimeError("proto_redesign needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()
    say(smi)
    with tempfile.TemporaryDirectory() as tmp:
        var_src = {name: variant_source(Path(tmp) / name.replace(" ", "_"),
                                        lines)
                   for name, lines in {**VARIANTS, **ABLATIONS}.items()}
        cuda_build.build(*SOURCES.values(), *old.values(), *var_src.values())
        parent_fns = fr.bind_parent(old, PARENT_ENTRIES)
        built = {name: bind_variant(cuda_build.load(src))
                 for name, src in var_src.items()}
        designs = {name: built[name] for name in VARIANTS}
        ablations = {name: built[name] for name in ABLATIONS}
        regs = {f"{name} {tree}": registers(p)
                for tree, paths in (("parent", old), ("new", SOURCES),
                                    *((v, {"zwin_proto.cu": s})
                                      for v, s in var_src.items()))
                for name, p in paths.items()}
        for k, v in regs.items():
            say(f"[registers] {k}, ptxas per kernel in build order: {v}")
        results = {"device": smi, "rounds": rounds, "inner": inner,
                   "registers": regs}
        for tag, shape in ZWIN_SHAPES.items():
            results[tag] = zwin_measure(tag, shape, parent_fns["P12"]["f32"],
                                        designs, ablations, rounds, inner)

        sim = lj_melt_sim(cells=20, t_init=1.44, seed=SEED,
                          dtype=torch.float32, device=dev)
        sim.setup()
        for dtype in (torch.float32, torch.float64):
            sfx = fr._sfx(dtype)
            setup = sorted_planes(sim, dtype=dtype)
            jit = sorted_planes(sim, jittered(sim, dtype, fr.JITTER), dtype)
            for tag, sp in ((f"32k setup {sfx}", setup), (f"32k {sfx}", jit)):
                results[tag] = fr.measure(
                    tag, fr.column_calls(sp, parent_fns, COLUMN), dtype,
                    rounds, inner, fr.force_scale(sp))
        del sim
        torch.cuda.empty_cache()
        sim = lj_melt_sim(cells=63, t_init=1.44, seed=SEED,
                          dtype=torch.float32, device=dev)
        sim.setup()
        sp = sorted_planes(sim, jittered(sim, torch.float32, fr.JITTER),
                           torch.float32)
        del sim
        results["1M f32"] = fr.measure(
            "1M f32", fr.column_calls(sp, parent_fns, COLUMN), torch.float32,
            rounds, inner, fr.force_scale(sp))
        torch.cuda.empty_cache()
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with an earlier tree's zwin_proto.cu, "
                         "lj_column_full.cu, lj_cell_force.cu and the "
                         "headers they include")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--inner", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args()
    main(args.parent, args.rounds, args.inner, args.out)
