"""Spans and counters at the port's layer boundaries.

The port's own timer, in the place of LAMMPS's Timer sections (ref:
src/timer.h:23-44): the run loop, its segments, re-binning, the pair
passes and the thermo output record spans here when tracing is on, and the
deck's `timer` command (script.LammpsScript.cmd_timer) or `enable()` turns
it on. Off, the default, a span is one shared no-op context manager and a
counter records nothing.

On, each span records its name, start and end (`time.perf_counter_ns`),
its parent and the `run` span it runs under. Aggregates per name (count,
total, self time: the duration less its children's) are kept in full, raw
records up to `RECORD_CAP` (the ones past it are counted as dropped).
While a torch.profiler is recording, each span also opens
`torch.profiler.record_function(name)`, so that it sits on the profiler's
timeline: the device work launched inside it, ctypes launches included,
links to the range as its launching op, and each idle gap of the device
falls under the spans open at that moment.

The spans are host times: on the card a launch returns before the device
has run it, so a span holds the host's time in it, and the device waits
show in the spans that read the device (`segment.read`, `output.read`).
On the card a segment's steps replay CUDA graphs (integrate/graphs), which
run no Python: the spans inside a step are recorded at a graph's capture
only, and its counters are added at each replay (`set_aside`). The step
loop counts `segment.graph_steps` (the steps of segments run from graphs)
and `segment.graph_captures`.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

RECORD_CAP = 100_000

ON = False

_stack: list = []        # the open spans, innermost last
_aggs: dict = {}         # name -> [count, total_ns, self_ns]
_counters: dict = {}
_records: list = []      # (id, name, start_ns, end_ns, parent_id, run_id)
_aside: list = []        # the open `set_aside` blocks' counts, innermost last
_dropped = 0
_next_id = 0


_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "sid", "parent", "run", "start", "child_ns", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _next_id
        _next_id += 1
        self.sid = _next_id
        self.parent = _stack[-1] if _stack else None
        self.run = (self.sid if self.name == "run"
                    else self.parent.run if self.parent else None)
        self.child_ns = 0
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        _stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        end = time.perf_counter_ns()
        _stack.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        dur = end - self.start
        agg = _aggs.get(self.name)
        if agg is None:
            agg = _aggs[self.name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - self.child_ns
        if self.parent is not None:
            self.parent.child_ns += dur
        if len(_records) < RECORD_CAP:
            _records.append((self.sid, self.name, self.start, end,
                             self.parent.sid if self.parent else None,
                             self.run))
        else:
            _dropped += 1
        return False


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def span(name: str):
    """A context manager timing `name` while tracing is on; the one shared
    no-op while it is off."""
    return _Span(name) if ON else _NOOP


def spanned(name: str):
    """Decorator: each call of the function in a span `name`. Off, the
    cost is one call through the wrapper and a test of `ON`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if ON:
                with _Span(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while tracing is on; inside a
    `set_aside` block, to that block's counts instead, on or off."""
    if _aside:
        _aside[-1][name] = _aside[-1].get(name, 0) + n
    elif ON:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def set_aside():
    """A block whose counts, whether tracing is on or not, go to the dict
    it yields and not to the counters: the capture of a CUDA graph
    (integrate/graphs), which runs no step, records there what each of its
    replays then adds with `count`."""
    got: dict = {}
    _aside.append(got)
    try:
        yield got
    finally:
        _aside.pop()


def snapshot() -> dict:
    """The aggregates (seconds), counters and raw records so far:
    {"spans": {name: {"count", "total_s", "self_s"}}, "counters": {name:
    n}, "records": [(id, name, start_ns, end_ns, parent_id, run_id)],
    "dropped": records not kept past RECORD_CAP}."""
    return {
        "spans": {k: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
                  for k, (c, t, s) in _aggs.items()},
        "counters": dict(_counters),
        "records": list(_records),
        "dropped": _dropped,
    }


def reset() -> None:
    """Forget every aggregate, counter and record (open spans still close
    into the fresh aggregates)."""
    global _dropped
    _aggs.clear()
    _counters.clear()
    _records.clear()
    _dropped = 0
