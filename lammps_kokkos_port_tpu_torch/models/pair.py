"""Pair-coefficient mixing rules (ref: src/pair.cpp:705-740).

The part of `lammps_kokkos_port_tpu/models/pair.py` that `pair_lj.py`
needs; the [N,K] neighbor-matrix engine of that module is not ported (the
sorted cell-major path does not use it).
"""

from __future__ import annotations

import math


def mix_epsilon(e1, e2, s1, s2, style: str) -> float:
    """Pair coeff mixing for epsilon (ref: src/pair.cpp:705 mix_energy)."""
    if style in ("geometric", "arithmetic"):
        return math.sqrt(e1 * e2)
    if style == "sixthpower":
        return (
            2.0 * math.sqrt(e1 * e2) * s1**3 * s2**3 / (s1**6 + s2**6)
        )
    raise ValueError(f"unknown mix style {style!r}")


def mix_sigma(s1, s2, style: str) -> float:
    """Pair coeff mixing for sigma (ref: src/pair.cpp:723 mix_distance)."""
    if style == "geometric":
        return math.sqrt(s1 * s2)
    if style == "arithmetic":
        return 0.5 * (s1 + s2)
    if style == "sixthpower":
        return (0.5 * (s1**6 + s2**6)) ** (1.0 / 6.0)
    raise ValueError(f"unknown mix style {style!r}")
