"""ForceField: the composition of force contributions (ref: src/force.h).

Port of `lammps_kokkos_port_tpu/models/forcefield.py`, pair-only: bonded
styles, kspace and special bonds are not ported yet. `compute` returns
(f, epair, emol, virial) like the JAX ForceField, through the function the
pair style names for the list's mode (its `force_paths`, models/pair):
the sorted layout (ops/sortedforce) or the dense cell buckets of list mode
"cell" (ops/cellforce).

`HybridOverlay` is pair_style hybrid/overlay: its force path sums the
(f, pe, virial) of its sub-styles over all pairs. Its sub-styles (SNAP,
ZBL) read one short list (ops/tersoff_kernels.short_lists, the seam every
short-list style shares), built at the largest of their cutoffs in the
span of the first of them by `short_rank`: SNAP's, so that the list is
timed in `pair.snap.short`, whatever the deck's order.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from ..core.state import State
from ..ops.tersoff_kernels import short_lists
from ..utils import trace
from .pair import ForcePaths


@dataclasses.dataclass(frozen=True)
class ForceField:
    pair: object

    def max_cutoff(self) -> float:
        return self.pair.max_cutoff()

    @trace.spanned("pair")
    def compute(self, state: State, nl, eflag: bool, vflag: bool):
        """Returns (f, epair, emol, virial6); epair/emol are None unless
        eflag, virial is None unless vflag."""
        fn = self.pair.force_paths.modes[nl.list_mode]
        f, pe, vir = fn(self.pair, state, nl, eflag, vflag)
        emol = (torch.zeros((), dtype=state.dtype, device=state.device)
                if eflag else None)
        return f, pe, emol, vir


def _overlay(ov, state, nl, eflag: bool, vflag: bool):
    """(f, pe, virial) of a hybrid/overlay on the sorted layout: one short
    list at the largest cutoff, built in the span of the first sub-style
    by `short_rank`, and the sum of the sub-styles' terms on it."""
    total, lists = None, None
    for s in sorted(ov.styles, key=lambda s: s.short_rank):
        with trace.span(f"pair.{s.trace_name}"):
            if lists is None:
                lists = short_lists(ov.max_cutoff(), state, nl, s.trace_name)
            terms = s.short_terms(s, state, nl, eflag, vflag, lists)
        total = terms if total is None else tuple(
            None if a is None else a + b for a, b in zip(total, terms))
    return total


@dataclasses.dataclass(frozen=True)
class HybridOverlay:
    """pair_style hybrid/overlay: sub-styles that read a short list (their
    `short_terms`: ZBL, SNAP), in the deck's order, each over every pair
    within its own cutoff (ref: src/pair_hybrid_overlay.cpp; one atom
    type, so no type-pair masks). List mode "sorted" alone, which "auto"
    resolves to."""

    styles: tuple

    force_paths: ClassVar[ForcePaths] = ForcePaths({"sorted": _overlay})

    def max_cutoff(self) -> float:
        return max(s.max_cutoff() for s in self.styles)


def from_pair(pair) -> ForceField:
    return ForceField(pair=pair)
