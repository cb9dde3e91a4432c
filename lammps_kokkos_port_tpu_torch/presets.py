"""Preset systems mirroring the reference benchmark decks.

Port of the LJ-melt and EAM presets of `lammps_kokkos_port_tpu/presets.py`:
they reproduce the setup phase of bench/in.lj, examples/melt/in.melt and
bench/in.eam bit for bit (positions and initial velocities), so thermo
output can be compared with the JAX package and the reference's golden
logs.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.box import Box
from .core.lattice import Lattice, create_atoms
from .core.state import State, create_state
from .core.velocity import create_velocities_geom
from .models.pair_lj import make_lj_cut
from .utils.units import get_units


def lj_melt_state(
    cells=10,
    rho: float = 0.8442,
    t_init: float = 3.0,
    seed: int = 87287,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> State:
    """`lattice fcc rho; region box block 0 n 0 n 0 n; create_atoms; mass 1 1;
    velocity all create T seed loop geom` (ref: examples/melt/in.melt,
    bench/in.lj with t_init=1.44, cells=20). `cells` may be a scalar or a
    per-dim tuple."""
    units = get_units("lj")
    lat = Lattice(style="fcc", scale=rho, units_name="lj", dimension=3)
    sp = lat.spacing
    lo = np.zeros(3)
    if np.isscalar(cells):
        cells = (cells, cells, cells)
    hi = np.array(cells, dtype=np.float64) * sp
    x, types = create_atoms(lat, lo, hi, type_id=1)
    masses = np.array([1.0, 1.0])  # slot 0 + type 1
    v = create_velocities_geom(x, masses[types], t_desired=t_init, seed=seed,
                               units=units)
    box = Box.create(lo, hi, dtype=torch.float64, device=device)
    return create_state(x, box, types=types, velocities=v, masses=masses,
                        units_name="lj", dtype=dtype, device=device)


def lj_melt_pair(dtype: torch.dtype = torch.float32, device="cpu"):
    """pair_style lj/cut 2.5; pair_coeff 1 1 1.0 1.0 2.5"""
    return make_lj_cut(ntypes=1, coeffs={(1, 1): (1.0, 1.0)}, cut_global=2.5,
                       dtype=dtype, device=device)


def lj_melt_sim(
    cells: int = 10,
    t_init: float = 3.0,
    seed: int = 87287,
    dtype: torch.dtype = torch.float32,
    every: int = 20,
    delay: int = 0,
    check: bool = False,
    list_mode: str = "auto",
    device="cpu",
):
    """Full melt Simulation ready to run (neigh_modify every 20 delay 0
    check no; skin 0.3; fix nve; dt 0.005)."""
    from .runner import Simulation

    state = lj_melt_state(cells=cells, t_init=t_init, seed=seed, dtype=dtype,
                          device=device)
    pair = lj_melt_pair(dtype=dtype, device=device)
    return Simulation(state, pair, skin=0.3, neigh_every=every,
                      neigh_delay=delay, neigh_check=check,
                      list_mode=list_mode)


def eam_bulk_cu_state(
    cells: int = 20,
    a0: float = 3.615,
    t_init: float = 1600.0,
    seed: int = 376847,
    *,
    potential_path: str,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> State:
    """bench/in.eam setup: metal units, fcc Cu 3.615, velocity create 1600
    376847 loop geom. Mass comes from the potential file (funcfl sets
    it)."""
    from .io.eam_reader import read_funcfl

    units = get_units("metal")
    ff = read_funcfl(potential_path)
    lat = Lattice(style="fcc", scale=a0, units_name="metal", dimension=3)
    sp = lat.spacing
    lo = np.zeros(3)
    hi = np.array([cells, cells, cells], dtype=np.float64) * sp
    x, types = create_atoms(lat, lo, hi, type_id=1)
    masses = np.array([1.0, ff.mass])
    v = create_velocities_geom(x, masses[types], t_desired=t_init, seed=seed,
                               units=units)
    box = Box.create(lo, hi, dtype=torch.float64, device=device)
    return create_state(x, box, types=types, velocities=v, masses=masses,
                        units_name="metal", dtype=dtype, device=device)


def eam_bulk_cu_sim(
    cells: int = 20,
    t_init: float = 1600.0,
    seed: int = 376847,
    *,
    potential_path: str,
    dtype: torch.dtype = torch.float32,
    device="cpu",
    list_mode: str = "auto",
):
    """Full bench/in.eam Simulation: pair_style eam with one funcfl file,
    skin 1.0, neigh_modify every 1 delay 5 check yes, fix nve, timestep
    0.005 ps. The port runs it on the dense path (list_mode="sorted"); in
    mode "auto" the JAX package takes its exact-spline matrix engine, which
    is not ported, so setup() raises."""
    from .models.pair_eam import make_eam_funcfl
    from .runner import Simulation

    state = eam_bulk_cu_state(cells=cells, t_init=t_init, seed=seed,
                              potential_path=potential_path, dtype=dtype,
                              device=device)
    pair = make_eam_funcfl(ntypes=1, files={1: potential_path}, dtype=dtype,
                           device=device)
    return Simulation(state, pair, dt=0.005, skin=1.0, neigh_every=1,
                      neigh_delay=5, neigh_check=True, list_mode=list_mode)
