"""PyTorch port, cell-major layout: expand/build/rebuild against JAX.

The port's sorted layout must be row for row the JAX layout (integer
fields and floats exact in fp64), so every later comparison can be made
row by row. The JAX side runs under jax.jit; inputs are made from a seed
with numpy and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.ops import neighbor as jax_nbr
from lammps_kokkos_port_tpu.ops import sortedforce as jax_sf
from lammps_kokkos_port_tpu.presets import lj_melt_state as jax_lj_melt_state
from lammps_kokkos_port_tpu_torch import interop
from lammps_kokkos_port_tpu_torch.ops import sortedforce as sf
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim

FIELDS = ("x", "v", "type", "tag", "image", "mask")


def _port_params(cells):
    """Grid and capacity chosen by the port's setup (the same sizing code
    as the JAX runner, pinned by test_torch_lj_melt)."""
    sim = lj_melt_sim(cells=cells, t_init=1.44, dtype=torch.float64)
    sim.setup()
    return sim.nl.params


def _jax_params(p):
    return jax_nbr.NeighborParams(**dataclasses.asdict(p))


def _to_port(jax_state):
    return interop.state_from_arrays(interop.dataclass_to_arrays(jax_state))


def _to_port_cells(jax_nl, p):
    return sf.SortedCells(ago=int(jax_nl.ago), nbuilds=int(jax_nl.nbuilds),
                          overflow=torch.tensor(bool(jax_nl.overflow)),
                          params=p)


def _assert_rows_equal(port_state, jax_state):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(port_state, k).numpy(),
                                      np.asarray(getattr(jax_state, k)),
                                      err_msg=k)


@pytest.fixture(scope="module")
def built():
    """Jittered melt state expanded and sorted by both packages."""
    p = _port_params(8)
    raw = jax_lj_melt_state(cells=8, t_init=1.44, dtype=jnp.float64)
    rng = np.random.default_rng(11)
    n = int(raw.nlocal)
    x = np.array(raw.x)
    x[:n] += rng.uniform(-0.3, 0.3, (n, 3))
    xw, img = raw.box.wrap(jnp.asarray(x), raw.image)
    raw = raw.replace(x=xw, image=img)

    jexp = jax_sf.expand_state(raw, _jax_params(p))
    texp = sf.expand_state(_to_port(raw), p)
    jst, jnl = jax.jit(jax_sf.build, static_argnums=1)(jexp, _jax_params(p))
    tst, tnl = sf.build(texp, p)
    return p, jexp, texp, jst, jnl, tst, tnl


def test_expand_and_build_match_jax(built):
    p, jexp, texp, jst, jnl, tst, tnl = built
    _assert_rows_equal(texp, jexp)
    _assert_rows_equal(tst, jst)
    assert not bool(tnl.overflow) and not bool(jnl.overflow)


def test_rebuild_state_matches_jax(built):
    """A seeded displacement under one cell, wrapped, re-binned in place
    by the sort-free local permutation."""
    p, _, _, jst, jnl, _, _ = built
    valid = np.asarray(jst.valid_mask)
    x = np.array(jst.x)
    rng = np.random.default_rng(12)
    x[valid] += rng.uniform(-0.6, 0.6, (int(valid.sum()), 3))
    xw, img = jst.box.wrap(jnp.asarray(x), jst.image)
    xw = jnp.where(jnp.asarray(valid)[:, None], xw, jst.x)  # keep pad rows
    jmoved = jst.replace(x=xw, image=jnp.where(jnp.asarray(valid)[:, None],
                                               img, jst.image))

    jout, jnl2 = jax.jit(jax_sf.rebuild_state)(jmoved, jnl)
    tout, tnl2 = sf.rebuild_state(_to_port(jmoved), _to_port_cells(jnl, p))
    _assert_rows_equal(tout, jout)
    assert not bool(tnl2.overflow) and not bool(jnl2.overflow)
    assert tnl2.nbuilds == int(jnl2.nbuilds) == 2
    # the displacement really re-binned atoms
    assert not np.array_equal(np.asarray(jout.tag), np.asarray(jst.tag))


def test_rebuild_flags_two_cell_jump():
    """An atom that jumps two cells between rebuilds cannot be re-binned
    locally: the overflow flag is raised, as in the JAX package."""
    p = _port_params(10)
    assert min(p.ncells) >= 5  # a 2-cell jump is not a wrapped 1-cell one
    raw = jax_lj_melt_state(cells=10, t_init=1.44, dtype=jnp.float64)
    jst, jnl = jax.jit(jax_sf.build, static_argnums=1)(
        jax_sf.expand_state(raw, _jax_params(p)), _jax_params(p))
    row = int(np.flatnonzero(np.asarray(jst.valid_mask))[0])
    edge = float(jst.box.prd[0]) / p.ncells[0]
    jumped = jst.replace(x=jst.x.at[row, 0].add(2.0 * edge))

    jnl2 = jax.jit(jax_sf.rebuild_state)(jumped, jnl)[1]
    tnl2 = sf.rebuild_state(_to_port(jumped), _to_port_cells(jnl, p))[1]
    assert bool(jnl2.overflow)
    assert bool(tnl2.overflow)
