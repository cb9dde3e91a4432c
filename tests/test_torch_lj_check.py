"""PyTorch port, lj/cut with `neigh_modify check yes` against JAX.

The port routes a distance-checked (or delay > every) lj/cut run through
its generic step (integrate/verlet.make_step: on-device rebuild decision,
the lj kernel's plain twin as the force pass); the JAX package runs the
same case through the `lax.cond` runner of its fused segment
(integrate/fused.py:250-256). fp64, sorted layout, cells 6; positions by
tag atol 1e-11 and etotal rel 1e-12 (as tests/test_sorted.py), and nbuilds
equal: the rebuild schedule itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once, and each worker's intra-op thread
    pool would otherwise claim every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_tag(state):
    x, valid, tag = (np.asarray(state.x), np.asarray(state.valid_mask),
                     np.asarray(state.tag))
    return x[valid][np.argsort(tag[valid])]


def test_lj_check_yes_matches_jax():
    """lj/cut under `neigh_modify every 1 delay 0 check yes`: the port's
    generic step with the lj kernel as its force pass (L3 lifted)."""
    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64, every=1,
                      delay=0, check=True)
    sim.setup()
    rows = sim.run(20)
    ref = jax_lj_melt_sim(cells=6, t_init=1.44, dtype=jnp.float64, every=1,
                          delay=0, check=True, list_mode="sorted")
    ref.setup()
    ref_rows = ref.run(20)

    assert sim.nl.nbuilds == int(ref.nl.nbuilds) > 1
    np.testing.assert_allclose(_by_tag(sim.state), _by_tag(ref.state),
                               rtol=0, atol=1e-11)
    assert rows[-1]["etotal"] == pytest.approx(ref_rows[-1]["etotal"],
                                               rel=1e-12)
