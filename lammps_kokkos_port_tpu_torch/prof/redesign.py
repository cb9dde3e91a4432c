"""The harness of the parent-versus-new kernel timings (`prof.lj_redesign`,
`prof.eam_redesign`): an earlier tree's library built beside this tree's,
inputs jittered from a seed, each kernel held against its plain twin and
timed by its device time per call, the kernels in turns. Card only.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import cuda_build

SEED = 87287
# a trace may miss the device events of a ctypes launch: try again
TRACE_ATTEMPTS = 5


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


def parent_library(source: Path, argtypes: dict) -> ctypes.CDLL:
    """An earlier tree's library of `source`, built if need be, with the
    entry points `<stem>_f32` and `<stem>_f64` of each stem in `argtypes`
    bound to that stem's ctypes argument types."""
    lib = cuda_build.load(source)
    for stem, types in argtypes.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{stem}_{suffix}")
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


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
