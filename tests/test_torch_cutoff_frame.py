"""PyTorch port, the frame of a pair at the cutoff across a wrapped face.

The port's sorted force path is a full 27-cell stencil (`lj_cell_force`);
the JAX decks run the Newton-half K1 (`column_half_force_pallas`), which
forms each pair once, from the cell whose half stencil holds the other,
and gives both rows that one decision. A full stencil that shifts the
candidate on both sides forms the two rows' displacements in two rounded
frames, so across a wrapped face the rows of a pair at the cutoff can be
decided apart (ROADMAP F12). The port forms each pair in K1's frame
(ops/pair_kernels.stencil, frame "half"; csrc/sorted_grid.cuh FramedGrid).

Inputs (prof/planted.wrapped_pairs): the JAX sorted grid of the 864-atom
melt, (3, 3, 3) x cc 32, every row a pad sentinel but one pair planted
across each periodic face, row j at X0 = (b + L) - 2.5 where r2 in K1's
frame is cutsq = 6.25, and one ulp either side; b is drawn from a seed
until the candidate frame takes a row-i decision K1 does not. Both rows of
each pair are held to JAX K1 (interpret mode) and to the JAX package's
XLA force path on the same state (ops/gridforce, minimum image): the same
decision on both rows, the forces within rtol 1e-12 (f64) / 1e-6 (f32) of
K1's (one pair: the terms differ by the frame's rounding at most).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.ops import pallas_pair
from lammps_kokkos_port_tpu.ops import sortedforce as jax_sortedforce
from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch.ops import pair_kernels
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import (
    lj_cell_force,
    stencil,
)
from lammps_kokkos_port_tpu_torch.prof import planted

DTYPES = {torch.float64: (jnp.float64, 1e-12),
          torch.float32: (jnp.float32, 1e-6)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_grid():
    sim = jax_lj_melt_sim(cells=6, t_init=1.44, dtype=jnp.float64, every=20,
                          delay=0, check=False, list_mode="sorted")
    sim.setup()
    assert tuple(sim.nl.params.ncells) == (3, 3, 3)
    return sim


def _planted(sim, dtype, case):
    p = sim.nl.params
    prd = torch.tensor(np.asarray(sim.state.box.prd), dtype=dtype)
    key = sim.pair_style.kernel_key()
    g, gi, rows, dec = planted.wrapped_pairs(p.ncells, p.cell_cap, prd,
                                             key[-1], dtype, case)
    return key, prd, g, gi, rows, dec


def _jax_k1(sim, key, g, prd, jdt):
    nx, ny, nz = sim.nl.params.ncells
    col = [jnp.asarray(a.numpy(), jdt).reshape(nx * ny, nz, -1) for a in g]
    ids = jnp.zeros_like(col[0])
    out = pallas_pair.column_half_force_pallas(
        key, (nx, ny, nz), g.shape[1] * g.shape[2], *col, ids,
        jnp.asarray(prd.numpy(), jdt))
    return torch.from_numpy(np.stack([np.asarray(a).reshape(-1)
                                      for a in out]))


def _jax_xla(sim, g, gi, prd, jdt):
    """The JAX package's XLA force path on the sorted state (the energy
    and virial evaluation: ops/gridforce's half stencil, minimum image)."""
    st = sim.state
    x = jnp.asarray(g.reshape(3, -1).t().numpy(), jdt)
    mask = jnp.asarray((gi.reshape(-1) >= 0).numpy().astype(np.int32))
    assert not np.asarray(st.box.lo).any()  # prd is hi
    box = dataclasses.replace(st.box, lo=st.box.lo.astype(jdt),
                              hi=jnp.asarray(prd.numpy(), jdt),
                              tilt=st.box.tilt.astype(jdt))
    st = st.replace(x=x, mask=mask, box=box)
    f = jax_sortedforce.compute(sim.pair_style, st, sim.nl, True, False)[0]
    return torch.from_numpy(np.asarray(f).T.copy())


@pytest.mark.parametrize("case", planted.CASES)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=["f64", "f32"])
def test_port_decides_each_pair_as_k1(jax_grid, dtype, case):
    """Both rows of each planted pair: the port's sorted force path (the
    plain twin on the CPU) takes K1's decision, as does the XLA path, and
    the forces agree."""
    jdt, rtol = DTYPES[dtype]
    key, prd, g, gi, rows, dec = _planted(jax_grid, dtype, case)
    launches = lj_cell_force.launches
    port = lj_cell_force(key, jax_grid.nl.params.ncells, *g, prd)
    assert lj_cell_force.launches == launches  # CPU: the plain version
    k1 = _jax_k1(jax_grid, key, g, prd, jdt)
    xla = _jax_xla(jax_grid, g, gi, prd, jdt)
    want = {axis: d["half"] for axis, d in dec.items()}
    assert planted.taken(k1, rows) == want
    assert planted.taken(xla, rows) == want
    assert planted.taken(port, rows) == want
    live = [r for pair in rows for r in pair]
    p, k = port.reshape(3, -1)[:, live], k1.reshape(3, -1)[:, live]
    torch.testing.assert_close(p, k.to(p.dtype), rtol=rtol,
                               atol=rtol * float(k.abs().max()))
    assert (port.reshape(3, -1).count_nonzero()
            == k1.reshape(3, -1).count_nonzero())


@pytest.mark.parametrize("dtype", list(DTYPES), ids=["f64", "f32"])
def test_candidate_frame_decides_rows_apart(jax_grid, dtype):
    """The planted pairs bite: the full stencil with the candidate shifted
    on both sides (the port before the repair; K7's frame) decides row i of
    some pair apart from K1 and from its own row j, while `mirrored`
    offsets are exactly the 13 outside the half stencil."""
    assert sum(map(pair_kernels.mirrored, pair_kernels._OFFSETS)) == 13
    assert not any(pair_kernels.mirrored(o) for o in pallas_pair._HALF)
    apart = 0
    for case in planted.CASES:
        key, prd, g, _, rows, dec = _planted(jax_grid, dtype, case)
        cutsq = key[-1]
        out = torch.zeros_like(g)
        ncells = jax_grid.nl.params.ncells
        for d, r2, pair_ok, _ in stencil(ncells, *g, prd):
            valid = r2 < cutsq
            if pair_ok is not None:
                valid &= pair_ok
            for dim in range(3):
                out[dim] += torch.where(valid, d[dim], 0.0).sum(-1).reshape(
                    out[dim].shape)
        got = planted.taken(out, rows)
        assert got == {axis: d["candidate"] for axis, d in dec.items()}
        apart += sum(gi != gj for gi, gj in got.values())
    assert apart > 0


def test_frames_are_validated():
    g = torch.zeros(27, 4, dtype=torch.float64)
    prd = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="frame"):
        next(stencil((3, 3, 3), g, g, g, prd, frame="image"))
    with pytest.raises(ValueError, match=">= 3 cells"):
        planted.wrapped_pairs((2, 3, 3), 4, [9.0] * 3, 6.25, torch.float64,
                              "at")
