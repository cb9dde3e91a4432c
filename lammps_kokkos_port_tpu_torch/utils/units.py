"""Unit systems.

A copy of `lammps_kokkos_port_tpu/utils/units.py` (numpy-free, framework-
free host config). Re-implements the reference's unit-system table
(ref: src/update.cpp:146-300 `Update::set_units`). Each unit style fixes the
fundamental conversion constants used throughout the force field and
integrators, plus the default timestep and neighbor skin.

Constants are plain Python floats, the analog of the reference's
`force->boltz` etc. member variables.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Units:
    name: str
    boltz: float  # Boltzmann constant (energy/degree-K)
    hplanck: float  # Planck's constant (energy-time)
    mvv2e: float  # conversion of mv^2 to energy
    ftm2v: float  # conversion of ft/m to velocity
    mv2d: float  # conversion of mass/volume to density
    nktv2p: float  # conversion of NkT/V to pressure
    qqr2e: float  # conversion of q^2/r to energy
    qe2f: float  # conversion of qE to force
    vxmu2f: float = 1.0
    xxt2kmu: float = 1.0
    angstrom: float = 1.0
    femtosecond: float = 1.0
    qelectron: float = 1.0
    dt: float = 0.005  # default timestep
    skin: float = 0.3  # default neighbor skin
    # whether thermo output is normalized per-atom by default
    # (ref: src/thermo.cpp `normflag`, lj units default to per-atom)
    norm_default: bool = False


# Values follow the NIST physical constants used by the reference
# (ref: src/update.cpp:140-300).
UNIT_SYSTEMS: dict[str, Units] = {
    "lj": Units(
        name="lj",
        boltz=1.0, hplanck=1.0, mvv2e=1.0, ftm2v=1.0, mv2d=1.0,
        nktv2p=1.0, qqr2e=1.0, qe2f=1.0,
        dt=0.005, skin=0.3, norm_default=True,
    ),
    "real": Units(
        name="real",
        boltz=0.0019872067, hplanck=95.306976368,
        mvv2e=48.88821291 * 48.88821291,
        ftm2v=1.0 / 48.88821291 / 48.88821291,
        mv2d=1.0 / 0.602214129, nktv2p=68568.415,
        qqr2e=332.06371, qe2f=23.060549,
        vxmu2f=1.4393264316e4, xxt2kmu=0.1,
        angstrom=1.0, femtosecond=1.0,
        dt=1.0, skin=2.0,
    ),
    "metal": Units(
        name="metal",
        boltz=8.617343e-5, hplanck=4.135667403e-3,
        mvv2e=1.0364269e-4, ftm2v=1.0 / 1.0364269e-4,
        mv2d=1.0 / 0.602214129, nktv2p=1.6021765e6,
        qqr2e=14.399645, qe2f=1.0,
        vxmu2f=0.6241509647, xxt2kmu=1.0e-4,
        angstrom=1.0, femtosecond=1.0e-3,
        dt=0.001, skin=2.0,
    ),
    "si": Units(
        name="si",
        boltz=1.3806504e-23, hplanck=6.62606896e-34,
        mvv2e=1.0, ftm2v=1.0, mv2d=1.0, nktv2p=1.0,
        qqr2e=8.9876e9, qe2f=1.0,
        angstrom=1.0e-10, femtosecond=1.0e-15, qelectron=1.6021765e-19,
        dt=1.0e-8, skin=0.001,
    ),
    "cgs": Units(
        name="cgs",
        boltz=1.3806504e-16, hplanck=6.62606896e-27,
        mvv2e=1.0, ftm2v=1.0, mv2d=1.0, nktv2p=1.0,
        qqr2e=1.0, qe2f=1.0,
        angstrom=1.0e-8, femtosecond=1.0e-15, qelectron=4.8032044e-10,
        dt=1.0e-8, skin=0.1,
    ),
    "electron": Units(
        name="electron",
        boltz=3.16681534e-6, hplanck=0.1519829846,
        mvv2e=1.06657236, ftm2v=0.937582899, mv2d=1.0,
        nktv2p=2.94210108e13, qqr2e=1.0, qe2f=1.94469051e-10,
        vxmu2f=3.39893149e1, xxt2kmu=3.13796367e-2,
        angstrom=1.88972612, femtosecond=1.0,
        dt=0.001, skin=2.0,
    ),
    "micro": Units(
        name="micro",
        boltz=1.3806504e-8, hplanck=6.62606896e-13,
        mvv2e=1.0, ftm2v=1.0, mv2d=1.0, nktv2p=1.0,
        qqr2e=8.987556e6, qe2f=1.0,
        angstrom=1.0e-4, femtosecond=1.0e-9, qelectron=1.6021765e-7,
        dt=2.0, skin=0.1,
    ),
    "nano": Units(
        name="nano",
        boltz=0.013806504, hplanck=6.62606896e-4,
        mvv2e=1.0, ftm2v=1.0, mv2d=1.0, nktv2p=1.0,
        qqr2e=230.7078669, qe2f=1.0,
        angstrom=1.0e-1, femtosecond=1.0e-6,
        dt=0.00045, skin=0.1,
    ),
}


def get_units(style: str) -> Units:
    try:
        return UNIT_SYSTEMS[style]
    except KeyError:
        raise ValueError(
            f"Unknown unit style {style!r}; available: {sorted(UNIT_SYSTEMS)}"
        ) from None
