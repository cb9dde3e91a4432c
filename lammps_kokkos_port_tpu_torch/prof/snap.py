"""Device time of the SNAP and ZBL kernels at the deck's sizes, on the card.

    python -m lammps_kokkos_port_tpu_torch.prof.snap --out <file>

For the benchmark's SNAP W deck (bench_port/configs/snap-w.in, seeded
coefficients) at 128,000 atoms (-var x 10) and 2,000 (-var x 2.5), in
float32 and float64: the sorted state after setup with positions
jittered by a seeded +-0.1 A, the short list at the overlay's cutoff;
each kernel timed by its own device time in torch.profiler traces
(prof.tersoff.kernel_ms: the median of its rounds; the wrappers' fills are
not counted). At 2,000 atoms also the plain twins' time on the card (CUDA
events, the median of three calls). Prints one JSON line a case, with the
counts the roofline needs (atoms, pairs within rcut) and the build log's
registers; `--out` also writes them as a JSON list.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import tempfile
import time
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops import snap_kernels as sk
from ..ops import tersoff_kernels as tk
from ..script import LammpsScript
from . import redesign
from .tersoff import kernel_ms
from .timing import say

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ROOT / "bench_port" / "configs"
SIZES = {"2k": "2.5", "128k": "10"}


def deck_sim(dtype, size: str, directory, device="cuda"):
    """The deck's Simulation after setup (its `run 0`), at a size of
    SIZES."""
    from bench_port import decks

    conf = json.loads((CONFIGS / "snap-w-fp64.json").read_text())
    pot = decks.potential(conf, CONFIGS, Path(directory))
    lines, _ = decks.make_deck(conf, 4928458, pot, CONFIGS)
    deck = Path(directory) / "deck.in"
    deck.write_text("\n".join(lines) + "\n")
    n = SIZES[size]
    script = LammpsScript(dtype=dtype, device=device, list_mode="sorted",
                          var_overrides={"x": n, "y": n, "z": n})
    with contextlib.redirect_stdout(io.StringIO()):
        script.file(str(deck))
        script.one("run 0")
    return script.sim


def plain_ms(fn) -> float:
    """The median of three CUDA-event timings of one call of fn."""
    times = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def case(size: str, dtype, directory) -> dict:
    t0 = time.perf_counter()
    sim = deck_sim(dtype, size, directory)
    setup_s = time.perf_counter() - t0
    snap, zbl = sorted(sim.pair_style.styles, key=lambda s: s.short_rank)
    x = redesign.jittered(sim, dtype, 0.1).contiguous()
    st = sim.state.replace(x=x)
    _, prd, short, nshort = tk.short_lists(4.8, st, sim.nl, "snap")
    if bool(sim.nl.overflow):
        raise RuntimeError(f"{size}: a short list is longer than "
                           f"{sim.nl.short_cap}")
    mask = st.mask
    par, zpar = snap.kernel_params(), zbl.kernel_params()
    table = sk._device_table(snap, dtype, x.device)
    u = sk.snap_ui(par, x, mask, short, nshort, prd)
    y = sk.snap_yi(par, table, mask, u)
    e = torch.zeros(x.shape[0], dtype=dtype, device=x.device)
    vir = torch.zeros((6, x.shape[0]), dtype=dtype, device=x.device)
    # the list's slots past a row's count are not written: read none
    live = torch.arange(short.shape[1], device=x.device)[None, :] < (
        nshort[:, None])
    d = x[torch.where(live, short, 0).long()] - x[:, None, :]
    d = d - prd * torch.round(d / prd)
    pairs = int((((d * d).sum(-1) < par[1]) & live).sum()) // 2
    out = {"size": size, "dtype": str(dtype).split(".")[-1],
           "grid": list(sim.nl.params.ncells),
           "cell_cap": sim.nl.params.cell_cap, "short_cap": short.shape[1],
           "rows": x.shape[0], "atoms": sim.state.nlocal,
           "pairs_rcut": pairs, "pairs_short": int(nshort.sum()) // 2,
           "table_entries": int(table[0].numel()), "setup_s": setup_s}
    calls = {
        "tersoff_short": lambda: tk.short_lists(4.8, st, sim.nl, "snap"),
        "snap_ui": lambda: sk.snap_ui(par, x, mask, short, nshort, prd),
        "snap_yi": lambda: sk.snap_yi(par, table, mask, u),
        "snap_yi_tally": lambda: sk.snap_yi_tally(par, table, mask, u, e),
        "snap_deidrj": lambda: sk.snap_deidrj(par, x, mask, short, nshort,
                                              prd, y),
        "snap_deidrj_tally": lambda: sk.snap_deidrj_tally(
            par, x, mask, short, nshort, prd, y, vir),
        "zbl_pair": lambda: sk.zbl_pair(zpar, x, mask, short, nshort, prd),
        "zbl_pair_tally": lambda: sk.zbl_pair_tally(zpar, x, mask, short,
                                                    nshort, prd)}
    out["device_ms"] = {k: kernel_ms(fn, k) for k, fn in calls.items()}
    if size == "2k":
        out["plain_ms"] = {
            "snap_ui": plain_ms(lambda: sk.snap_ui_reference(
                par, x, mask, short, nshort, prd)),
            "snap_yi": plain_ms(lambda: sk.snap_yi_reference(
                par, snap.table, mask, u)),
            "snap_deidrj": plain_ms(lambda: sk.snap_deidrj_reference(
                par, x, mask, short, nshort, prd, y)),
            "zbl_pair": plain_ms(lambda: sk.zbl_pair_reference(
                zpar, x, mask, short, nshort, prd))}
    del sim
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--sizes", default="2k,128k")
    args = ap.parse_args(argv)
    say(f"[card] {redesign.card()}")
    sk._library()
    log = cuda_build.lib_path(sk.SOURCE).with_suffix(".log")
    say(f"[ptxas] {log.read_text() if log.exists() else 'no log'}")
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for size in args.sizes.split(","):
            for dtype in (torch.float32, torch.float64):
                res = case(size, dtype, tmp)
                say(json.dumps(res))
                results.append(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
