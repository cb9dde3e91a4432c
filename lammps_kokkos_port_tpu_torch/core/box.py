"""Simulation box: orthogonal, periodic-aware coordinate transforms.

Port of `lammps_kokkos_port_tpu/core/box.py` (ref: src/domain.h:25-120,
src/domain.cpp — boxlo/boxhi, x2lamda/lamda2x, pbc remap, minimum image).
Only orthogonal boxes are ported: a nonzero tilt raises
NotImplementedError. The arithmetic follows the JAX Box term by term
(fractional coordinates through 1/prd, wrap through lamda and back), so
the two packages agree bit for bit in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Box:
    """Orthogonal simulation cell; `lo`, `hi` are [3] tensors and `tilt`
    is kept (all zeros) so the field set matches the JAX Box."""

    lo: torch.Tensor  # (3,)
    hi: torch.Tensor  # (3,)
    tilt: torch.Tensor  # (3,) = (xy, xz, yz), zero
    periodic: tuple[bool, bool, bool] = (True, True, True)
    triclinic: bool = False

    @staticmethod
    def create(lo, hi, tilt=None, periodic=(True, True, True),
               dtype=torch.float64, device="cpu") -> "Box":
        if tilt is not None and np.any(np.asarray(tilt) != 0.0):
            raise NotImplementedError("triclinic boxes are not ported yet")
        lo = torch.as_tensor(np.asarray(lo, dtype=np.float64), dtype=dtype,
                             device=device)
        hi = torch.as_tensor(np.asarray(hi, dtype=np.float64), dtype=dtype,
                             device=device)
        return Box(lo=lo, hi=hi, tilt=torch.zeros_like(lo),
                   periodic=tuple(bool(p) for p in periodic))

    def to(self, dtype=None, device=None) -> "Box":
        """Copy with the tensors in `dtype` on `device`."""
        conv = lambda a: a.to(dtype=dtype, device=device)  # noqa: E731
        return dataclasses.replace(self, lo=conv(self.lo), hi=conv(self.hi),
                                   tilt=conv(self.tilt))

    @property
    def prd(self) -> torch.Tensor:
        """Edge lengths (xprd, yprd, zprd)."""
        return self.hi - self.lo

    @property
    def volume(self) -> torch.Tensor:
        p = self.prd
        return p[0] * p[1] * p[2]

    def _periodic(self, a: torch.Tensor) -> torch.Tensor:
        """Zero the non-periodic components of a [..., 3] tensor. A fully
        periodic box skips the multiply (by exact ones), which spares a
        host-to-device copy of the mask on every call."""
        if all(self.periodic):
            return a
        return a * torch.tensor([float(p) for p in self.periodic],
                                dtype=a.dtype, device=a.device)

    # -- coordinate transforms (ref: src/domain.cpp x2lamda/lamda2x) --------

    def to_lamda(self, x: torch.Tensor) -> torch.Tensor:
        """Box coords -> fractional coords in [0,1) for wrapped atoms."""
        return (x - self.lo) * (1.0 / self.prd)

    def to_box(self, lamda: torch.Tensor) -> torch.Tensor:
        """Fractional coords -> box coords."""
        return lamda * self.prd + self.lo

    # -- PBC ----------------------------------------------------------------

    def wrap(self, x: torch.Tensor, image: torch.Tensor | None = None):
        """Remap atoms into the primary cell, updating image flags
        (Domain::pbc): shift by whole box lengths so lamda lands in [0,1).
        Non-periodic dims are left untouched. Returns (x_wrapped, image)."""
        lamda = self.to_lamda(x)
        shift = self._periodic(torch.floor(lamda))
        xw = self.to_box(lamda - shift)
        if image is not None:
            image = image + shift.to(image.dtype)
        return xw, image

    def min_image(self, dx: torch.Tensor) -> torch.Tensor:
        """Minimum-image displacement (ref: Domain::minimum_image); valid
        when the cutoff is below half the smallest box length."""
        p = self.prd
        return dx - self._periodic(p) * torch.round(dx / p)
