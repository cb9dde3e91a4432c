"""The profiling scripts' slope timer, scan body and device line.

`slope_ms` is the counterpart of the scripts' `scan_time`
(benchmarks/prof/prof_sorted_ablate.py:24-36, prof_v3_32k.py:9-19): the
time per iteration of `carry = body(carry)` from the slope between k1 and
k2 iterations, so the fixed cost of a run cancels.
"""

from __future__ import annotations

import math
import subprocess
import time

import torch


# the scripts' coupling of one iteration to the next: carry + EPS * forces
EPS = 1e-30


def say(line: str) -> None:
    print(line, flush=True)


def force_body(forces):
    """The scripts' scan body: (gx, gy, gz) -> (g + EPS * f) per channel,
    for `forces(gx, gy, gz)` returning three tensors of the same sizes, so
    every iteration depends on the one before."""
    def body(c):
        return tuple(g + EPS * f.reshape(g.shape)
                     for g, f in zip(c, forces(*c)))
    return body


def sync(device: torch.device) -> None:
    """Wait for the card (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(carry) -> torch.device:
    if isinstance(carry, torch.Tensor):
        return carry.device
    return _device_of(carry[0])


def slope_ms(body, carry, k1: int = 20, k2: int = 60, reps: int = 1) -> float:
    """ms per iteration of `carry = body(carry)`: one untimed run of k1
    iterations (kernel builds, allocator warm-up), then `reps` pairs of
    timed runs of k1 and k2 iterations from the same `carry`, each
    synchronised before and after; the best slope of the pairs.

    Unlike the scripts' `lax.scan` inside one jitted call, the iterations
    are a Python loop of eager launches, so the slope includes each
    iteration's launch cost on the host (a few microseconds per launch)
    wherever the device finishes faster than the host enqueues."""
    device = _device_of(carry)

    def run(k: int) -> float:
        c = carry
        sync(device)
        t0 = time.perf_counter()
        for _ in range(k):
            c = body(c)
        sync(device)
        return time.perf_counter() - t0

    run(k1)
    best = math.inf
    for _ in range(reps):
        t1, t2 = run(k1), run(k2)
        best = min(best, (t2 - t1) / (k2 - k1) * 1e3)
    return best


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    CPU (where no number is a device figure)."""
    if device.type != "cuda":
        return "device: cpu (plain PyTorch twins; no card figure)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[device.index or 0]
