"""PyTorch port, the SNAP and ZBL CUDA kernels against their plain twins.

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). Run it
on the card with:

    python -m pytest --noconftest -m cuda tests/test_torch_snap_cuda.py

Inputs: the sorted state of the benchmark's SNAP W deck
(bench_port/configs/snap-w.in, its seeded coefficients) at 2,000 atoms
(-var x 2.5: 10 x 10 x 10 bcc cells) after setup, positions jittered by a
seeded +-0.1 A, in float32 and float64; the short list at the overlay's
cutoff (ZBL's 4.8 A). The twins run on the same CUDA tensors (they are
plain PyTorch), each kernel fed the twin's own inputs (U for yi, Y for
deidrj), so that each is held alone.

Tolerances. U: the kernel sums a row's pairs in the list's order as the
twin does, and lets the compiler fuse multiplies and adds: f64 atol 1e-12,
f32 1e-5 of the largest |U| (entries grow to about 30 at j = 8). Y: a sum
of up to 430 table terms an entry, taken in other orders (the kernel's
chunks and shared-memory atomics) and up to ten times the result: f64
1e-11, f32 1e-4 of the largest |Y|. Forces: the kernel lands each pair on
j by atomics, in an order that changes from run to run, and sums 155
entries by a warp reduction; each pair's dE/dr is a sum of terms up to a
hundred times its size: f64 rtol 1e-10 with atol 1e-10, f32 atol 1e-3 of
the largest |force|. The tallies (summed over rows in float64 on both
sides): f64 rtol 1e-11 (virial atol 1e-10 of its largest term), f32 pe
rtol 1e-5, virial atol 1e-4 of its largest term. The tally launches'
forces and Y equal the step launches' to the atomics' rounding. ZBL:
one thread a row, the twin's order: f64 rtol 1e-12, f32 1e-5.
"""

import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

from bench_port import decks
from lammps_kokkos_port_tpu_torch.ops import snap_kernels as sk
from lammps_kokkos_port_tpu_torch.ops import tersoff_kernels as tk
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import tally_sums
from lammps_kokkos_port_tpu_torch.script import LammpsScript
from lammps_kokkos_port_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

CONFIGS = Path(__file__).resolve().parents[1] / "bench_port" / "configs"
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _script(dtype, device, directory, nrep="2.5"):
    conf = json.loads((CONFIGS / "snap-w-fp64.json").read_text())
    pot = decks.potential(conf, CONFIGS, Path(directory))
    lines, _ = decks.make_deck(conf, 4928458, pot, CONFIGS)
    deck = Path(directory) / "deck.in"
    deck.write_text("\n".join(lines) + "\n")
    script = LammpsScript(dtype=dtype, device=device, list_mode="sorted",
                          var_overrides={"x": nrep, "y": nrep, "z": nrep})
    with contextlib.redirect_stdout(io.StringIO()):
        script.file(str(deck))
        script.one("run 0")
    return script


def _inputs(dtype, device, directory):
    sim = _script(dtype, device, directory).sim
    st = sim.state
    gen = torch.Generator(device=device).manual_seed(7)
    jitter = (torch.rand(st.x.shape, generator=gen, device=device,
                         dtype=torch.float64) - 0.5) * 0.2
    x = torch.where(st.valid_mask[:, None], st.x.double() + jitter,
                    st.x.double()).to(dtype).contiguous()
    return sim, st.replace(x=x)


def _close(got, ref, dtype, rel64, rel32):
    amax = ref.abs().max().item()
    if dtype == torch.float64:
        torch.testing.assert_close(got, ref, rtol=rel64, atol=rel64 * amax)
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=rel32 * amax)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_kernels_match_twins(cuda, dtype, tmp_path):
    sim, st = _inputs(dtype, cuda, tmp_path)
    snap, zbl = sorted(sim.pair_style.styles, key=lambda s: s.short_rank)
    x, prd, short, nshort = tk.short_lists(4.8, st, sim.nl, "snap")
    assert not bool(sim.nl.overflow)
    mask = st.mask
    valid = mask != 0
    par = snap.kernel_params()
    table = sk._device_table(snap, dtype, cuda)
    names = ("snap_ui", "snap_yi", "snap_yi_tally", "snap_deidrj",
             "snap_deidrj_tally", "zbl_pair", "zbl_pair_tally")
    n0 = [getattr(sk, k).launches for k in names]

    u = sk.snap_ui(par, x, mask, short, nshort, prd)
    r_u = sk.snap_ui_reference(par, x, mask, short, nshort, prd)
    _close(u[valid], r_u[valid], dtype, 1e-12, 1e-5)

    y = sk.snap_yi(par, table, mask, r_u)
    r_y, r_e = sk.snap_yi_reference(par, snap.table, mask, r_u, tally=True)
    _close(y[valid], r_y[valid], dtype, 1e-11, 1e-4)
    e = torch.zeros(x.shape[0], dtype=dtype, device=cuda)
    y_t = sk.snap_yi_tally(par, table, mask, r_u, e)
    _close(y_t[valid], y[valid], dtype, 1e-12, 1e-5)
    rel = 1e-11 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(e[valid].double().sum(),
                               r_e[valid].double().sum(), rtol=rel, atol=0)

    f = sk.snap_deidrj(par, x, mask, short, nshort, prd, r_y)
    r_f, r_v = sk.snap_deidrj_reference(par, x, mask, short, nshort, prd,
                                        r_y, tally=True)
    _close(f, r_f, dtype, 1e-10, 1e-3)
    vir = torch.zeros((6, x.shape[0]), dtype=dtype, device=cuda)
    f_t = sk.snap_deidrj_tally(par, x, mask, short, nshort, prd, r_y, vir)
    _close(f_t, f, dtype, 1e-12, 1e-5)
    zero = torch.zeros_like(r_v[:1])
    sums = tally_sums(torch.cat([zero, vir]), valid)[1:]
    r_sums = tally_sums(torch.cat([zero, r_v]), valid)[1:]
    vrel = 1e-10 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(sums, r_sums, rtol=vrel,
                               atol=vrel * r_sums.abs().max().item())

    zpar = zbl.kernel_params()
    fz = sk.zbl_pair(zpar, x, mask, short, nshort, prd)
    r_fz, r_tz = sk.zbl_pair_reference(zpar, x, mask, short, nshort, prd,
                                       True)
    _close(fz, r_fz, dtype, 1e-12, 1e-5)
    fz_t, tz = sk.zbl_pair_tally(zpar, x, mask, short, nshort, prd)
    _close(fz_t, fz, dtype, 1e-12, 1e-5)
    _close(tally_sums(tz, valid), tally_sums(r_tz, valid), torch.float64,
           1e-12 if dtype == torch.float64 else 1e-5, 0)

    assert [getattr(sk, k).launches for k in names] == [n + 1 for n in n0]


def test_deck_runs_on_the_card(cuda, tmp_path):
    """The deck (float64, 2,000 atoms) through `LammpsScript` on the card:
    one launch of each step kernel a force pass and of each tally kernel a
    row,
    the spans under `timer full`, and the energy conserved over run 20 as
    on the CPU."""
    script = _script(torch.float64, cuda, tmp_path)
    names = ("snap_ui", "snap_yi", "snap_deidrj", "zbl_pair",
             "snap_yi_tally", "snap_deidrj_tally", "zbl_pair_tally")
    n0 = [getattr(sk, k).launches for k in names]
    trace.enable()
    trace.reset()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            script.one("timer full")
            rows = script.cmd_run(["20"])
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    # the run's first force pass (Verlet::setup) and its 20 steps; ui also
    # serves the 3 rows
    got = [getattr(sk, k).launches - n for k, n in zip(names, n0)]
    assert got == [24, 21, 21, 21, 3, 3, 3]
    assert [r["step"] for r in rows] == [0, 10, 20]
    drift = abs(rows[-1]["etotal"] - rows[0]["etotal"])
    assert drift < 1e-6 * abs(rows[0]["epair"])
    for name in ("pair.snap", "pair.snap.short", "pair.snap.ui",
                 "pair.snap.yi", "pair.snap.deidrj", "pair.zbl"):
        assert snap["spans"][name]["count"] > 0, name
    assert snap["counters"]["pair.snap_tally_rows"] == 3
    assert "Pair" in out.getvalue()
