"""Pair style lj/cut: 12-6 Lennard-Jones with cutoff.

Port of `lammps_kokkos_port_tpu/models/pair_lj.py` (ref:
src/pair_lj_cut.cpp:69-140 compute, :501-557 init_one). Per-type-pair
coefficient tables:

    lj1 = 48 eps sigma^12   lj2 = 24 eps sigma^6    (force)
    lj3 =  4 eps sigma^12   lj4 =  4 eps sigma^6    (energy)

with forcelj = r6inv (lj1 r6inv - lj2), fpair = forcelj / r^2, and
evdwl = r6inv (lj3 r6inv - lj4) - offset.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import cellforce, pair_kernels
from .pair import ForcePaths, mix_epsilon, mix_sigma


@dataclasses.dataclass(frozen=True)
class PairLJCut:
    """Coefficient tables are [ntypes+1, ntypes+1] tensors; row/col 0
    unused."""

    lj1: torch.Tensor
    lj2: torch.Tensor
    lj3: torch.Tensor
    lj4: torch.Tensor
    cutsq: torch.Tensor
    offset: torch.Tensor
    ntypes: int
    cut_global_max: float

    def cutsq_table(self) -> torch.Tensor:
        return self.cutsq

    def max_cutoff(self) -> float:
        return self.cut_global_max

    @functools.cached_property
    def force_paths(self) -> ForcePaths:
        """List mode "cell" at any number of types (ops/cellforce);
        "sorted" (and so "auto") at one type (`kernel_key`: the cell force
        kernel, ops/pair_kernels.compute_sorted)."""
        modes = {"cell": cellforce.compute}
        if self.kernel_key() is not None:
            modes["sorted"] = pair_kernels.compute_sorted
        return ForcePaths(modes)

    def kernel_key(self):
        """Hashable scalar-coefficient key ("lj", lj1, lj2, cutsq) for the
        cell force kernels (ops/pair_kernels, ops/cell_kernels), or None
        when the style is not a single-type style. Read from the device
        once per style: the force pass asks for it on every step."""
        return self._kernel_key

    @functools.cached_property
    def _kernel_key(self):
        if self.ntypes != 1:
            return None
        tab = torch.stack([self.lj1[1, 1], self.lj2[1, 1],
                           self.cutsq[1, 1]]).cpu().tolist()
        return ("lj", float(tab[0]), float(tab[1]), float(tab[2]))

    def tally_key(self):
        """Hashable scalar-coefficient key ("lj", lj1, lj2, lj3, lj4,
        offset, cutsq) for the tally instance of the cell force kernel
        (thermo rows, ops/pair_kernels.lj_cell_force_tally), or None when
        the style is not a single-type style. Read from the device once per
        style, as `kernel_key`."""
        return self._tally_key

    @functools.cached_property
    def _tally_key(self):
        if self.ntypes != 1:
            return None
        tab = torch.stack([self.lj1[1, 1], self.lj2[1, 1], self.lj3[1, 1],
                           self.lj4[1, 1], self.offset[1, 1],
                           self.cutsq[1, 1]]).cpu().tolist()
        return ("lj", *(float(v) for v in tab))

    def pair_terms(self, r2, ti, tj, eflag: bool):
        """(fpair, evdwl) for squared distances `r2`; `ti`/`tj` are type
        tensors broadcastable to r2 (None for a single-type style)."""
        if self.ntypes == 1:
            lj1, lj2 = self.lj1[1, 1], self.lj2[1, 1]
            lj3, lj4, off = self.lj3[1, 1], self.lj4[1, 1], self.offset[1, 1]
        else:
            ti, tj = ti.long(), tj.long()
            lj1, lj2 = self.lj1[ti, tj], self.lj2[ti, tj]
            lj3, lj4 = self.lj3[ti, tj], self.lj4[ti, tj]
            off = self.offset[ti, tj]
        r2inv = 1.0 / r2
        r6inv = r2inv * r2inv * r2inv
        fpair = r6inv * (lj1 * r6inv - lj2) * r2inv
        evdwl = None
        if eflag:
            evdwl = r6inv * (lj3 * r6inv - lj4) - off
        return fpair, evdwl


def make_lj_cut(
    ntypes: int,
    coeffs: dict[tuple[int, int], tuple],
    cut_global: float,
    mix: str = "geometric",
    shift: bool = False,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> PairLJCut:
    """Build coefficient tables from pair_coeff entries.

    `coeffs[(i, j)] = (epsilon, sigma)` or `(epsilon, sigma, cut)` with
    1-based types, i <= j. Unset cross terms are generated by mixing
    (ref: src/pair.cpp:261-287 init_one loop; src/pair_lj_cut.cpp init_one).
    """
    nt = ntypes
    eps = np.zeros((nt + 1, nt + 1))
    sig = np.zeros((nt + 1, nt + 1))
    cut = np.full((nt + 1, nt + 1), cut_global)
    setflag = np.zeros((nt + 1, nt + 1), dtype=bool)

    for (i, j), c in coeffs.items():
        i, j = min(i, j), max(i, j)
        eps[i, j] = c[0]
        sig[i, j] = c[1]
        if len(c) > 2:
            cut[i, j] = c[2]
        setflag[i, j] = True

    for i in range(1, nt + 1):
        if not setflag[i, i]:
            raise ValueError(f"pair coeff for type pair ({i},{i}) not set")
    for i in range(1, nt + 1):
        for j in range(i + 1, nt + 1):
            if not setflag[i, j]:
                eps[i, j] = mix_epsilon(eps[i, i], eps[j, j], sig[i, i],
                                        sig[j, j], mix)
                sig[i, j] = mix_sigma(sig[i, i], sig[j, j], mix)
                # unset cutoffs mix like distances (ref: init_one)
                cut[i, j] = mix_sigma(cut[i, i], cut[j, j], mix)

    lj1 = np.zeros_like(eps)
    lj2 = np.zeros_like(eps)
    lj3 = np.zeros_like(eps)
    lj4 = np.zeros_like(eps)
    off = np.zeros_like(eps)
    for i in range(1, nt + 1):
        for j in range(i, nt + 1):
            e, s, c = eps[i, j], sig[i, j], cut[i, j]
            lj1[i, j] = 48.0 * e * s**12
            lj2[i, j] = 24.0 * e * s**6
            lj3[i, j] = 4.0 * e * s**12
            lj4[i, j] = 4.0 * e * s**6
            if shift and c > 0.0:
                ratio = s / c
                off[i, j] = 4.0 * e * (ratio**12 - ratio**6)
            for a in (lj1, lj2, lj3, lj4, off, eps, sig, cut):
                a[j, i] = a[i, j]

    tab = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return PairLJCut(
        lj1=tab(lj1), lj2=tab(lj2), lj3=tab(lj3), lj4=tab(lj4),
        cutsq=tab(cut * cut), offset=tab(off),
        ntypes=nt,
        cut_global_max=float(cut[1:, 1:].max()),
    )
