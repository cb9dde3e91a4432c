"""The segment runners' steps on the card, captured in CUDA graphs and
replayed.

No TPU counterpart: the JAX package compiles a whole segment with
`lax.fori_loop` under `jit`; PyTorch runs eagerly, so each step of a
segment costs its launches from Python (43 in the EAM deck's generic step).
On the sorted layout a step reads the host nowhere (the rebuild decision
stays on the device, ops/sortedforce), so its shapes and its launches are
the same on every step, and one step is captured once and replayed.

A step here is a function of no arguments (`body`) that reads and writes
only buffers that outlive its graph, the runner's carry: the rows of the
state, the box and masses, and the list's device tensors, each in a buffer
of its own (`own_state`). A segment copies the caller's state and list into
the carry (`load`), replays its steps, and hands out clones (`unload`), so
that no tensor handed out of a segment aliases a graph's buffer: the
grow-retry's snapshot, `Simulation.state` and a thermo row's snapshot hold
those across later segments.

`StepGraph` runs the body once eagerly on a side stream (one of the
segment's own steps), then captures it, and replays it for the steps after.
The capture itself runs nothing. Counting, so that the counters tell the
truth under replay: the launch counters of the kernel wrappers (their
`launches`) and the counts of utils/trace made while capturing are taken
back out, and each replay adds them again. The runner counts its steps on
`segment.graph_steps` and each capture on `segment.graph_captures`.

`Graphs` holds a runner's carry and graphs for one key, the things that fix
a step's shapes and path (`layout_key`). The graphs of a key share one
memory pool: they replay one after another on one stream, and a step's
temporaries die inside its graph (all that outlives a step is in the
carry), so one pool holds one step's temporaries whatever the number of
kinds. A new key (a grow-retry's new params) drops the old key's graphs
and frees their pool.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from ..utils import trace

PACKAGE = __name__.split(".")[0]
# the per-row arrays of a state (None where the atom style has no q or
# molecule)
ROWS = ("x", "v", "f", "type", "tag", "image", "mask", "q", "molecule")


def layout_key(state, nl) -> tuple:
    """What fixes a step's shapes and path: the capacity, dtype and device,
    the list's params and short-list width, the optional rows present and
    the number of mass slots."""
    return (state.capacity, state.dtype, state.device, nl.params,
            nl.short_cap, state.q is None, state.molecule is None,
            tuple(state.mass.shape))


def _own(a):
    """An uninitialised contiguous buffer like `a` (None for None)."""
    return (None if a is None
            else torch.empty_like(a, memory_format=torch.contiguous_format))


def own_state(state, rows=ROWS):
    """`state` with buffers of its own for `rows`, the box and the masses
    (not filled: `load` fills them)."""
    box = state.box
    return state.replace(
        **{k: _own(getattr(state, k)) for k in rows},
        mass=_own(state.mass),
        box=dataclasses.replace(box, lo=_own(box.lo), hi=_own(box.hi),
                                tilt=_own(box.tilt)))


def own_list(nl, fields):
    """`nl` with buffers of its own for `fields` (ago and nbuilds as 0-d
    int64 device tensors)."""
    dev = nl.overflow.device
    return dataclasses.replace(nl, **{
        k: (torch.empty((), dtype=torch.int64, device=dev)
            if k in ("ago", "nbuilds") else _own(getattr(nl, k)))
        for k in fields})


def _put(dst, src) -> None:
    if dst is None:
        return
    if isinstance(src, torch.Tensor):
        dst.copy_(src)
    else:
        dst.fill_(src)


def load(carry_state, carry_nl, state, nl, rows, fields) -> None:
    """Copy the state's `rows`, box and masses and the list's `fields`
    into the carry's buffers."""
    for k in rows:
        _put(getattr(carry_state, k), getattr(state, k))
    _put(carry_state.mass, state.mass)
    for k in ("lo", "hi", "tilt"):
        _put(getattr(carry_state.box, k), getattr(state.box, k))
    for k in fields:
        _put(getattr(carry_nl, k), getattr(nl, k))


def keep(carry, out, names) -> None:
    """Copy each of `out`'s `names` into the carry's buffer of that name
    where it is another tensor: a step's fresh arrays. The card's in-place
    updates are the carry's own buffers already."""
    for k in names:
        a, b = getattr(out, k), getattr(carry, k)
        if a is not None and a is not b:
            b.copy_(a)


def unload(carry_state, carry_nl, state, nl, rows, fields):
    """(state, nl) with clones of the carry's `rows` and `fields`: nothing
    handed out aliases the carry."""

    def clone(a):
        return None if a is None else a.clone()

    return (state.replace(**{k: clone(getattr(carry_state, k))
                             for k in rows}),
            dataclasses.replace(nl, **{k: clone(getattr(carry_nl, k))
                                       for k in fields}))


def counted_kernels() -> list:
    """Every kernel wrapper with a `.launches` counter in the port's loaded
    modules (a wrapper a body calls is loaded), each once."""
    fns = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith(PACKAGE + "."):
            for f in vars(mod).values():
                if callable(f) and isinstance(getattr(f, "launches", None),
                                              int):
                    fns[id(f)] = f
    return list(fns.values())


class StepGraph:
    """`body` run eagerly once, then captured in a CUDA graph and replayed
    (see the module's note)."""

    def __init__(self, body, device: torch.device, pool):
        self.body = body
        self.device = device
        self.pool = pool  # the memory pool the capture allocates from
        self.graph = None
        self.launches: list = []  # [(wrapper, launches a replay makes)]
        self.counts: dict = {}    # utils/trace counts a replay makes

    def _capture(self) -> None:
        stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.body()  # the eager step before the capture
            wrappers = counted_kernels()
            before = [w.launches for w in wrappers]
            graph = torch.cuda.CUDAGraph()
            with trace.set_aside() as counts:
                with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                    self.body()
        current.wait_stream(stream)
        for w, n in zip(wrappers, before):
            if w.launches != n:
                self.launches.append((w, w.launches - n))
                w.launches = n
        self.counts = counts
        self.graph = graph
        trace.count("segment.graph_captures")

    def run(self, nsteps: int) -> None:
        """`nsteps` steps on the current stream: the first of them eagerly
        and the capture where the body has no graph yet, replays after."""
        if nsteps <= 0:
            return
        if self.graph is None:
            self._capture()
            nsteps -= 1
        for _ in range(nsteps):
            self.graph.replay()
        for w, n in self.launches:
            w.launches += n * nsteps
        for name, n in self.counts.items():
            trace.count(name, n * nsteps)


class Graphs:
    """A runner's carry and its step graphs for one key (`use`), which
    share a memory pool; a new key drops the old key's graphs, which frees
    their pool."""

    def __init__(self):
        self.key = None
        self.device = None
        self.carry = None
        self.pool = None
        self.steps: dict = {}

    def use(self, key, device: torch.device, make_carry):
        """The carry for `key` on `device`, made by make_carry() where the
        key is new."""
        if key != self.key:
            self.steps.clear()
            self.carry = self.pool = None
            self.carry = make_carry()
            self.key, self.device = key, device
            self.pool = torch.cuda.graph_pool_handle()
        return self.carry

    def run(self, kind: str, nsteps: int) -> None:
        """`nsteps` steps of the carry's method `kind`."""
        g = self.steps.get(kind)
        if g is None:
            g = self.steps[kind] = StepGraph(getattr(self.carry, kind),
                                             self.device, self.pool)
        g.run(nsteps)
