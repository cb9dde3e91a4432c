"""Reduce a torch.profiler trace of the port's runs, taken with the port's
own spans on (`lammps_kokkos_port_tpu_torch.utils.trace`), to the device
time and the idle time of each span.

While a profiler records, each program span is a `record_function` range
on the profiler's clock. Three rules make the numbers add up:

- the device-side copies of the ranges (`is_user_annotation` device
  events, which run from a range's first kernel to its last, gaps and
  all) are dropped: they are not device work, and counted as busy they
  would cover the idle gaps inside every span;
- a device operation belongs to the spans open on the host when the CUDA
  runtime call that launched it started (the CPU event named `cuda...`
  or `cu...` with the operation's correlation id). The profiler also
  lists each operation under the PyTorch op open at its launch (an
  event's `kernels`), but not the kernels launched through ctypes,
  which no op encloses, and twice where the launch queue was full (a
  "Command Buffer Full" event holds them as well);
- an idle gap of the device inside the runs (the `run` spans) belongs to
  the spans open on the host at its middle.

"Self" is the innermost open span, "under" every open span (a span's own
time and its children's).
"""

from __future__ import annotations

RUN = "run"


def _open_chains(spans, times):
    """For each of the sorted `times`, the names of the spans open there,
    outermost first. `spans`: [(start, end, name)] sorted by start; the
    program's spans nest, so those open at one time form a chain."""
    out, open_, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            open_.append(spans[k])
            k += 1
        open_ = [s for s in open_ if s[1] >= t]
        out.append(tuple(s[2] for s in open_))
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events, names, kernels=()) -> dict:
    """The trace's events (`profile.events()`), the program's span names,
    and the kernel names whose device time is followed by span (operations
    named `<kernel>_kernel`) -> times in seconds (the profiler's are us):

    {"window_s": wall of the `run` spans, "busy_s": union of the device
     operations inside them, "idle_s": window less busy,
     "device_s": device time of every operation,
     "unattributed_device_s": device time put down to no span (launched
     outside every span, or with no runtime call of its id in the trace),
     "spans": {name: {"device_self_s", "device_s", "idle_self_s",
                      "idle_s"}},
     "kernels": {kernel: {"total_s", "calls", "by_span": {innermost span:
                 s}}}}"""
    from torch.autograd import DeviceType

    names = set(names)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ops = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name not in names
           and not e.name.startswith("ProfilerStep")]
    # outer spans first where two start together
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in cpu if e.name in names),
                   key=lambda s: (s[0], -s[1]))
    runs = [(a, b) for a, b, n in spans if n == RUN]
    per = {n: {"device_self_s": 0.0, "device_s": 0.0, "idle_self_s": 0.0,
               "idle_s": 0.0} for n in names}

    def charge(chain, key, seconds):
        if chain:
            per[chain[-1]][key + "_self_s"] += seconds
        for n in set(chain):
            per[n][key + "_s"] += seconds

    # device time, by the spans open where its runtime call started
    launch = {e.id: e.time_range.start for e in cpu
              if e.name.startswith("cu")}
    timed = sorted((k for k, o in enumerate(ops) if o.id in launch),
                   key=lambda k: launch[ops[k].id])
    chain_of = dict(zip(timed, _open_chains(
        spans, [launch[ops[k].id] for k in timed])))
    kern = {k: {"total_s": 0.0, "calls": 0, "by_span": {}} for k in kernels}
    attributed = 0.0
    for k, o in enumerate(ops):
        dur = o.time_range.elapsed_us() * 1e-6
        chain = chain_of.get(k, ())
        charge(chain, "device", dur)
        attributed += dur if chain else 0.0
        for kn, entry in kern.items():
            if f"{kn}_kernel" in o.name:
                where = chain[-1] if chain else None
                entry["total_s"] += dur
                entry["calls"] += 1
                by = entry["by_span"]
                by[where] = by.get(where, 0.0) + dur

    # idle gaps inside the runs, by the spans open at each gap's middle
    merged = _union((o.time_range.start, o.time_range.end) for o in ops)
    gaps, busy = [], 0.0
    for ra, rb in runs:
        inside = [(max(a, ra), min(b, rb)) for a, b in merged
                  if b > ra and a < rb]
        busy += sum(b - a for a, b in inside)
        edges = [ra] + [x for ab in inside for x in ab] + [rb]
        gaps += [(0.5 * (a + b), b - a)
                 for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort()
    for (_, width), chain in zip(gaps, _open_chains(spans,
                                                    [m for m, _ in gaps])):
        charge(chain, "idle", width * 1e-6)

    window = sum(b - a for a, b in runs)
    device = sum(o.time_range.elapsed_us() for o in ops) * 1e-6
    return {
        "window_s": window * 1e-6, "busy_s": busy * 1e-6,
        "idle_s": (window - busy) * 1e-6, "device_s": device,
        "unattributed_device_s": device - attributed,
        "spans": per, "kernels": kern,
    }
