"""The profiling scripts' slope timer, scan body and device line.

`slope_ms` is the counterpart of the scripts' `scan_time`
(benchmarks/prof/prof_sorted_ablate.py:24-36, prof_v3_32k.py:9-19): the
time per iteration of `carry = body(carry)` from the slope between k1 and
k2 iterations, so the fixed cost of a run cancels. On the card the k
iterations are one CUDA graph each, as a `lax.scan` is one program, so the
slope is device time; on the CPU they are an eager loop.
"""

from __future__ import annotations

import math
import subprocess
import time

import torch

from ..integrate.graphs import counted_kernels


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

    On a CUDA carry the untimed run is eager, on a side stream, and each
    timed run is the replay of a CUDA graph that holds its k iterations
    (captured once per k, and replayed once untimed before the pairs), so
    the slope is the device's time per iteration, as the scripts'
    `lax.scan` gives it, and holds no host launch cost. A kernel wrapper
    counts one launch when it is captured, and its kernel runs at every
    replay: the captured counts are taken back and each replay adds them,
    so `.launches` counts the kernels that ran. A body must not read the
    device from the host (no `.item()`): the capture would fail. On the CPU
    the runs are an eager Python loop."""
    device = _device_of(carry)

    def run(k: int) -> float:
        c = carry
        sync(device)
        t0 = time.perf_counter()
        for _ in range(k):
            c = body(c)
        sync(device)
        return time.perf_counter() - t0

    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run(k1)
        torch.cuda.current_stream(device).wait_stream(side)
        run = _graph_runs(body, carry, (k1, k2), device)
        run(k1), run(k2)  # the first replay uploads the graph
    else:
        run(k1)
    best = math.inf
    for _ in range(reps):
        t1, t2 = run(k1), run(k2)
        best = min(best, (t2 - t1) / (k2 - k1) * 1e3)
    return best


def _graph_runs(body, carry, ks, device):
    """Capture k iterations of `body` from `carry` in one CUDA graph for
    each k in `ks`; return run(k), the host time of one synchronised replay
    of k's graph, which adds the captured launches to the counters."""
    counters = counted_kernels()
    graphs = {}
    for k in ks:
        before = [f.launches for f in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            c = carry
            for _ in range(k):
                c = body(c)
        added = [f.launches - n for f, n in zip(counters, before)]
        for f, n in zip(counters, before):
            f.launches = n
        graphs[k] = (graph, added, c)

    def run(k: int) -> float:
        graph, added, _ = graphs[k]
        sync(device)
        t0 = time.perf_counter()
        graph.replay()
        sync(device)
        dt = time.perf_counter() - t0
        for f, n in zip(counters, added):
            f.launches += n
        return dt

    return run


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
