"""Helpers of the card-only kernel timings (`chip_smoke.py`,
`prof.tersoff`, `prof.rebin`): the card's name and power limit, a source's
register counts from its build log, inputs jittered from a seed, a kernel
held against its plain twin, and each kernel's device time per call from
checked torch.profiler traces, the kernels in turns.
"""

from __future__ import annotations

import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import cuda_build
from .timing import say

SEED = 87287
# traces of one call before device_times gives up: a trace can miss device
# records (all of them for a 2-microsecond ctypes launch, and some of the
# first launches of a trace late in a long process, both seen on an H100;
# five traces of one call in a row have lost records)
TRACE_ATTEMPTS = 8


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def registers(source: Path) -> list:
    """ptxas's register counts of a source's kernels, from its build log
    (in the compiler's order)."""
    log = cuda_build.lib_path(source).with_suffix(".log")
    if not log.exists():
        return []
    return [int(line.split("Used ")[1].split()[0])
            for line in log.read_text().splitlines() if "Used " in line]


def jittered(sim, dtype, amplitude: float) -> torch.Tensor:
    """`sim`'s positions, real rows moved by a seeded uniform +-amplitude
    in each component, pads as they are, in `dtype`."""
    st = sim.state
    gen = torch.Generator(device=st.device).manual_seed(SEED)
    jitter = (torch.rand(st.x.shape, generator=gen, device=st.device,
                         dtype=torch.float64) - 0.5) * (2 * amplitude)
    return torch.where(st.valid_mask[:, None], st.x.double() + jitter,
                       st.x.double()).to(dtype)


def check(label: str, got, ref, dtype) -> float:
    """got within rtol * (max|ref| + |ref|) of ref (f32 rtol 1e-4, f64
    1e-10); the max abs error."""
    torch.cuda.synchronize()
    rtol = 1e-4 if dtype == torch.float32 else 1e-10
    err = (got - ref).abs()
    vmax = ref.abs().max().item()
    bad = int((err > rtol * vmax + rtol * ref.abs()).sum())
    if bad or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: {bad} values out of tolerance")
    return err.max().item()


def trace(fn, inner: int) -> tuple:
    """(summed device-op time in us, number of device ops) of `inner`
    calls of fn in one torch.profiler trace, taken after a warm-up step of
    `inner` calls with the profiler on (the step's own range, which the
    trace also shows on the device, is not an op)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    ops = []

    def keep(prof):
        ops.extend(e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep"))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=keep) as prof:
        for _ in range(2):
            for _ in range(inner):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return sum(e.time_range.elapsed_us() for e in ops), len(ops)


def device_times(calls: dict, rounds: int, inner: int) -> dict:
    """Device time per call (ms) of each of `calls`: the summed device-op
    time of `inner` calls in one trace (`trace`), the calls in turns, the
    median of `rounds`. A trace counts when its device ops are a nonzero
    multiple of `inner` and no fewer than any counted before for that call
    (a trace that lost records holds fewer), and the median is over the
    traces with the most; a call traced TRACE_ATTEMPTS times in a row
    without such a trace raises."""
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    kept = {k: [] for k in calls}
    for _ in range(rounds):
        for k, fn in calls.items():
            for attempt in range(TRACE_ATTEMPTS):
                us, n = trace(fn, inner)
                if n and n % inner == 0 and n >= max(
                        (m for m, _ in kept[k]), default=0):
                    kept[k].append((n, us / inner / 1e3))
                    break
                say(f"[device_ms] a trace of {k} holds {n} device ops for "
                    f"{inner} calls (attempt {attempt + 1} of "
                    f"{TRACE_ATTEMPTS})")
            else:
                raise RuntimeError(f"no complete trace of {k}")
    return {k: statistics.median(ms for n, ms in v
                                 if n == max(m for m, _ in v))
            for k, v in kept.items()}
