"""PyTorch port, energy/virial path of thermo steps against JAX.

`sortedforce.compute` with eflag/vflag takes the grid-roll path
(ops/gridforce) in both packages. Same jittered sorted state, fp64:
forces atol 1e-11, energy and virial rel 1e-12 (only the summation order
differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lammps_kokkos_port_tpu.ops import neighbor as jax_nbr
from lammps_kokkos_port_tpu.ops import sortedforce as jax_sf
from lammps_kokkos_port_tpu.presets import lj_melt_pair as jax_lj_melt_pair
from lammps_kokkos_port_tpu.presets import lj_melt_state as jax_lj_melt_state
from lammps_kokkos_port_tpu_torch import interop
from lammps_kokkos_port_tpu_torch.ops import sortedforce as sf
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim


def test_gridforce_matches_jax():
    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64)
    sim.setup()
    p = sim.nl.params
    jp = jax_nbr.NeighborParams(**dataclasses.asdict(p))
    raw = jax_lj_melt_state(cells=6, t_init=1.44, dtype=jnp.float64)
    jst, jnl = jax.jit(jax_sf.build, static_argnums=1)(
        jax_sf.expand_state(raw, jp), jp)
    valid = np.asarray(jst.valid_mask)
    x = np.array(jst.x)
    rng = np.random.default_rng(5)
    x[valid] += rng.uniform(-0.05, 0.05, (int(valid.sum()), 3))
    jst = jst.replace(x=jnp.asarray(x))

    jpair = jax_lj_melt_pair(dtype=jnp.float64)
    f_ref, pe_ref, vir_ref = jax.jit(
        lambda style, st, nl: jax_sf.compute(style, st, nl, True, True))(
            jpair, jst, jnl)

    st = interop.state_from_arrays(interop.dataclass_to_arrays(jst))
    pair = interop.pair_from_arrays(interop.dataclass_to_arrays(jpair))
    cl = sf.SortedCells(ago=0, nbuilds=1, overflow=torch.tensor(False),
                        params=p)
    f, pe, vir = sf.compute(pair, st, cl, True, True)

    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(pe.item(), float(pe_ref), rtol=1e-12)
    np.testing.assert_allclose(vir.numpy(), np.asarray(vir_ref), rtol=1e-12)
    assert abs(pe.item()) > 1.0 and np.abs(vir.numpy()).max() > 1.0
