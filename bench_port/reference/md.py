"""Velocity-Verlet NVE and the thermo row, as LAMMPS defines them.

`System` holds what a deck fixes: the box, the mass, the time step, the
unit constants and the pair model. `integrate` advances positions and
velocities with forces of every pair within the cutoff at every step: its
own list has a skin of `System.skin` and is built again whenever an atom
has moved more than half of it (LAMMPS's `check yes`), so no pair is ever
missed. `thermo` gives the row's potential energy, pressure and
temperature, and a scale for the pressure's gap.
"""

from __future__ import annotations

import dataclasses

import torch

from .models import Precision
from .neighbors import half_pairs

# LAMMPS unit constants (src/update.cpp set_units)
UNITS = {
    "lj": dict(boltz=1.0, mvv2e=1.0, ftm2v=1.0, nktv2p=1.0, norm=True),
    "metal": dict(boltz=8.617343e-5, mvv2e=1.0364269e-4,
                  ftm2v=1.0 / 1.0364269e-4, nktv2p=1.6021765e6, norm=False),
}


@dataclasses.dataclass
class System:
    prd: torch.Tensor   # [3] box lengths, float64
    mass: float
    dt: float
    units: str
    model: object       # a pair model (models.py states its contract)
    skin: float

    @property
    def c(self) -> dict:
        return UNITS[self.units]

    def pairs(self, x):
        return half_pairs(x, self.prd, self.model.cutoff + self.skin)

    def forces(self, x, prec: Precision, energy: bool = False, pairs=None):
        pairs = self.pairs(x) if pairs is None else pairs
        return self.model.evaluate(x, self.prd, pairs, prec, energy)


def thermo(system: System, x, v, prec: Precision) -> dict:
    """pe (per atom where the units normalise), press, temp of the state,
    and `press_scale`: the pressure the kinetic term and the summed
    magnitudes of the pair virials would give, the scale of its rounding."""
    c = system.c
    n = x.shape[0]
    res = system.forces(x.to(prec.state), prec, energy=True)
    vp = v.to(prec.pair)
    mv2 = float((system.mass * (vp * vp).sum(-1)).to(prec.state).sum())
    dof = 3.0 * (n - 1)
    temp = mv2 * c["mvv2e"] / (dof * c["boltz"])
    vol = float(torch.prod(system.prd))
    kin = dof * c["boltz"] * temp
    press = (kin + sum(res.virial[:3])) / (3.0 * vol) * c["nktv2p"]
    scale = (kin + res.virial_abs) / (3.0 * vol) * c["nktv2p"]
    pe = res.pe / n if c["norm"] else res.pe
    return {"pe": pe, "press": press, "temp": temp, "press_scale": scale,
            "f": res.f, "band": res.band}


def integrate(system: System, x, v, steps: int, prec: Precision):
    """(x, v, f) after `steps` NVE steps from (x, v): half kick, drift,
    forces, half kick (fix nve). Positions stay unwrapped."""
    x = x.to(prec.state).clone()
    v = v.to(prec.state).clone()
    dtf = 0.5 * system.dt * system.c["ftm2v"] / system.mass
    half_skin_sq = (0.5 * system.skin) ** 2
    pairs = system.pairs(x)
    xhold = x.clone()
    f = system.forces(x, prec, pairs=pairs).f
    for _ in range(steps):
        v = v + dtf * f
        x = x + system.dt * v
        if float(((x - xhold) ** 2).sum(-1).max()) > half_skin_sq:
            pairs = system.pairs(x)
            xhold = x.clone()
        f = system.forces(x, prec, pairs=pairs).f
        v = v + dtf * f
    return x, v, f
