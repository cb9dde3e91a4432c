"""ForceField: the composition of force contributions (ref: src/force.h).

Port of `lammps_kokkos_port_tpu/models/forcefield.py`, pair-only: bonded
styles, kspace and special bonds are not ported yet. `compute` returns
(f, epair, emol, virial) like the JAX ForceField, through the function the
pair style names for the list's mode (its `force_paths`, models/pair):
the sorted layout (ops/sortedforce) or the dense cell buckets of list mode
"cell" (ops/cellforce).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import State
from ..utils import trace


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


def from_pair(pair) -> ForceField:
    return ForceField(pair=pair)
