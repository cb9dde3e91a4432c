"""PyTorch port, the Tersoff CUDA kernels against their plain twins.

Needs an NVIDIA GPU with nvcc (marker `cuda`; skipped elsewhere). Run it
on the card with:

    python -m pytest --noconftest -m cuda tests/test_torch_tersoff_cuda.py

Inputs: the sorted state of bench/POTENTIALS/in.tersoff at its published
32,000 atoms after setup, on the repository's Si.tersoff, positions
jittered by a seeded +-0.1 A, in float32 and float64. The twins run on the
same CUDA tensors (they are plain PyTorch).

Tolerances. The short list: exact. The kernel forms r2 with the twin's
rounded operations and appends in the twin's walk order, so the counts
and the lists are equal entry for entry. The forces: the kernel lands the
forces on j and k by atomics, in an order that changes from run to run,
and lets the compiler fuse multiplies and adds; the twin sums in another
order. f64: rtol 1e-10 with atol 1e-10 of the largest |force|; f32: atol
1e-4 of the largest |force| (a force is a sum of terms up to about ten
times its size, each rounded at 6e-8). The tally's pe and virial, summed
over rows in float64 on both sides: f64 rtol 1e-10 (virial atol 1e-10 of
its largest term: an off-diagonal term can be near 0); f32 pe rtol 1e-5
and virial atol 1e-4 of its largest term. The tally launch's forces equal
the step launch's to the atomics' rounding: f64 atol 1e-12, f32 1e-5 of
the largest |force|.
"""

import dataclasses
from pathlib import Path

import pytest
import torch

from lammps_kokkos_port_tpu_torch.ops import tersoff_kernels as tk
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


def _script(dtype, device):
    text = (CONFIGS / "tersoff-si.in").read_text().replace(
        "Si.tersoff", str(CONFIGS / "Si.tersoff"))
    script = LammpsScript(dtype=dtype, device=device, list_mode="sorted")
    for line in text.splitlines():
        if not line.startswith("run"):
            script.one(line)
    script.one("run 0")
    return script


def _inputs(dtype, device):
    sim = _script(dtype, device).sim
    st = sim.state
    gen = torch.Generator(device=device).manual_seed(7)
    jitter = (torch.rand(st.x.shape, generator=gen, device=device,
                         dtype=torch.float64) - 0.5) * 0.2
    x = torch.where(st.valid_mask[:, None], st.x.double() + jitter,
                    st.x.double()).to(dtype).contiguous()
    return sim, x, st.mask, st.box.prd.to(dtype)


def _flags(device):
    return (torch.zeros((), dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _close(got, ref, dtype, rel64=1e-10, rel32=1e-4):
    amax = ref.abs().max().item()
    if dtype == torch.float64:
        torch.testing.assert_close(got, ref, rtol=rel64, atol=rel64 * amax)
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=rel32 * amax)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_kernels_match_twins(cuda, dtype):
    sim, x, mask, prd = _inputs(dtype, cuda)
    style = sim.pair_style
    p = sim.nl.params
    cutsq = style.max_cutoff() ** 2
    par = style.kernel_params()
    n0 = (tk.tersoff_short.launches, tk.tersoff_force.launches,
          tk.tersoff_force_tally.launches)
    overflow, need = _flags(cuda)
    short, nshort = tk.tersoff_short(cutsq, p.ncells, x, mask, prd, 16,
                                     overflow, need)
    r_short, r_nshort, counts = tk.tersoff_short_reference(
        cutsq, p.ncells, x, mask, prd, 16)
    assert torch.equal(nshort, r_nshort)
    assert int(counts.max()) <= 16 and not bool(overflow)
    assert int(need) == 0
    slot = torch.arange(16, device=cuda)
    used = slot[None, :] < nshort[:, None]
    assert torch.equal(short[used], r_short[used])
    assert 3.5 < float(nshort.sum()) / sim.state.nlocal < 4.5

    f = tk.tersoff_force(par, x, short, nshort, prd)
    r_f, r_tally = tk.tersoff_force_reference(par, x, r_short, r_nshort,
                                              prd, tally=True)
    _close(f, r_f, dtype)
    f_t, tally = tk.tersoff_force_tally(par, x, short, nshort, prd)
    _close(f_t, f, dtype, rel64=1e-12, rel32=1e-5)
    valid = mask != 0
    sums = tk.tally_sums(tally, valid)
    r_sums = tk.tally_sums(r_tally, valid)
    rel = 1e-10 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(sums[0], r_sums[0], rtol=rel, atol=0)
    vmax = r_sums[1:].abs().max().item()
    vrel = 1e-10 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(sums[1:], r_sums[1:], rtol=vrel,
                               atol=vrel * vmax)
    assert (tk.tersoff_short.launches, tk.tersoff_force.launches,
            tk.tersoff_force_tally.launches) == (n0[0] + 1, n0[1] + 1,
                                                 n0[2] + 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_planted_overflow_grows_and_retries(cuda, dtype):
    """A list cut to three wide (4 neighbours an atom) overflows the first
    step: the segment is re-run with the list widened, and the state is
    the unplanted run's."""
    planted = _script(dtype, cuda).sim
    plain = _script(dtype, cuda).sim
    n_short = tk.tersoff_short.launches
    planted.nl = dataclasses.replace(planted.nl, short_cap=3)
    trace.enable()
    trace.reset()
    try:
        planted.run(10, 10)
        counters = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert counters["neigh.short_grows"] == 1
    assert counters["segment.retries"] == 1
    assert planted.nl.short_cap == 11 and not bool(planted.nl.overflow)
    assert tk.tersoff_short.launches > n_short
    plain.run(10, 10)
    f_a = planted.force_fn(planted.state, planted.nl, False, False)[0]
    f_b = plain.force_fn(plain.state, plain.nl, False, False)[0]
    _close(f_a, f_b, dtype, rel64=1e-9, rel32=1e-3)
    torch.testing.assert_close(planted.state.x, plain.state.x, rtol=0,
                               atol=1e-9 if dtype == torch.float64 else 1e-4)
