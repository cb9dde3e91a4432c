"""Spans wrapped around the program from outside, and the reduction of one
torch.profiler trace to the numbers the per-layer readers take.

`annotated` wraps module functions (or instance methods) in profiler
ranges for the duration. `traced_runs` traces a stretch of the window's
own runs after a warm-up run with the profiler on (the profiler's
`warmup` step). Every traced run is the deck's same `run`, so each holds
the same device operations: a trace in which they differ lost records
(or a run grew its capacity) and is taken again, up to `ATTEMPTS` times;
the trace with the most device operations is kept. The kernels launched
through ctypes are not attributed to an enclosing range: device time is
read by kernel name, and ranges are read only where they hold PyTorch
operations alone.
"""

from __future__ import annotations

import contextlib
import heapq

ATTEMPTS = 3
NAME_CHARS = 160  # a device operation's name in `breakdown`, cut to this
# per-run device operations may differ this much without a retake (the EAM
# step's operations vary by about 0.1% from run to run)
OPS_SPREAD = 0.01
RUN_RANGE = "bench.run"


@contextlib.contextmanager
def annotated(targets):
    """[(owner, attribute, label), ...]: each callable wrapped in a
    `record_function(label)` range until the block ends."""
    from torch.profiler import record_function

    saved = []
    for owner, name, label in targets:
        fn = getattr(owner, name)

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            with record_function(_label):
                return _fn(*args, **kwargs)

        saved.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, wrapped)
    try:
        yield
    finally:
        for owner, name, old in reversed(saved):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)


def _self_device_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _range_device_us(e, ranges) -> float:
    """Device time of the operations under a range: the self device time of
    every descendant that is not itself a range (a range's own device-side
    span, first to last kernel with its gaps, is not device time)."""
    total = 0.0
    for c in e.cpu_children:
        if c.name not in ranges:
            total += _self_device_us(c)
        total += _range_device_us(c, ranges)
    return total


def _trace_once(run_once, nruns, labels):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    kept = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=nruns),
                 on_trace_ready=lambda p: kept.append(p.events())) as prof:
        for _ in range(nruns + 1):
            with record_function(RUN_RANGE):
                run_once()
            torch.cuda.synchronize()
            prof.step()
    events = kept[0]
    names = set(labels) | {RUN_RANGE}
    ops = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in names and not e.name.startswith("ProfilerStep")]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    runs = sorted((e.time_range.start, e.time_range.end) for e in cpu
                  if e.name == RUN_RANGE)
    per_run = [sum(1 for o in ops if a <= o.time_range.start < b)
               for a, b in runs]
    return events, ops, cpu, runs, per_run


def traced_runs(run_once, nruns: int, labels: list[str], kernels) -> dict:
    """Trace `nruns` calls of run_once() and reduce the trace (times in
    seconds): wall of the traced runs, device busy time (the union of the
    device operations' intervals), device operations, each kernel's total
    time and calls (by kernel name `<kernel>_kernel`), each label's device
    time, the `breakdown` lists and the retakes."""
    from torch.autograd import DeviceType

    best, counts = None, []
    for _ in range(ATTEMPTS):
        got = _trace_once(run_once, nruns, labels)
        counts.append(got[4])
        if best is None or len(got[1]) > len(best[1]):
            best = got
        if min(got[4]) > 0 and max(got[4]) <= (1 + OPS_SPREAD) * min(got[4]):
            best = got
            break
    events, ops, cpu, runs, per_run = best
    if not ops:
        raise RuntimeError("the trace shows no device operation")

    # device busy: the union of the operations' intervals inside the runs
    spans = sorted((o.time_range.start, o.time_range.end) for o in ops)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    window_us = sum(b - a for a, b in runs)
    busy_us = 0.0
    for a, b in merged:
        for ra, rb in runs:
            busy_us += max(0.0, min(b, rb) - max(a, ra))

    by_name = {}
    for o in ops:
        name = o.name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + o.time_range.elapsed_us()
    kern = {}
    for k in kernels:
        sel = [o.time_range.elapsed_us() for o in ops
               if f"{k}_kernel" in o.name]
        if sel:
            kern[k] = {"total_s": sum(sel) * 1e-6, "calls": len(sel)}
    names = set(labels) | {RUN_RANGE}
    ranges = {lab: sum(_range_device_us(e, names) for e in cpu
                       if e.name == lab and e.device_type == DeviceType.CPU)
              * 1e-6 for lab in labels}

    return {
        "runs": len(runs), "window_s": window_us * 1e-6,
        "busy_s": busy_us * 1e-6, "device_ops": len(ops),
        "ops_per_run": per_run, "retakes": len(counts) - 1,
        "counts_per_attempt": counts, "kernels": kern, "ranges": ranges,
        "breakdown": {
            "device_ops": sorted(([n, t * 1e-6] for n, t in by_name.items()),
                                 key=lambda p: -p[1])[:10],
            "idle_gaps": _idle_gaps(merged, runs, cpu, set(labels)),
        },
    }


def _idle_gaps(merged, runs, cpu, labels, top: int = 10):
    """Idle time between device operations inside the runs, summed by what
    the host was doing at each gap's middle: the innermost harness range
    and the innermost host event open there (one sweep over the gaps in
    time order; the innermost open event is the latest-starting one)."""
    mids = []
    for ra, rb in runs:
        edges = [ra] + [x for a, b in merged if b > ra and a < rb
                        for x in (max(a, ra), min(b, rb))] + [rb]
        mids += [(0.5 * (a + b), b - a) for a, b in zip(edges[0::2],
                                                        edges[1::2]) if b > a]
    mids.sort()
    ev = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                if e.name != RUN_RANGE and not e.name.startswith(
                    "ProfilerStep"))
    open_ranges, open_ops = [], []
    k, gaps = 0, {}
    for mid, width in mids:
        while k < len(ev) and ev[k][0] <= mid:
            s, e, name = ev[k]
            heapq.heappush(open_ranges if name in labels else open_ops,
                           (-s, e, name))
            k += 1
        names = []
        for heap, none in ((open_ranges, "run"), (open_ops, "python")):
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            names.append(heap[0][2] if heap else none)
        key = "/".join(names)
        gaps[key] = gaps.get(key, 0.0) + width * 1e-6
    return sorted(([k, v] for k, v in gaps.items()), key=lambda p: -p[1])[:top]
