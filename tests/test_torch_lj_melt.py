"""PyTorch port, the LJ-melt slice end to end on CPU.

The port's Simulation (sorted layout, fused NVE segment, plain twin of the
CUDA force kernel) against the JAX package's sorted-mode Simulation (Pallas
kernels in interpret mode), and against the reference's golden log.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim

# step-0 row of examples/melt/log.8Apr21.melt.g++.1 (tests/test_lj_melt.py)
GOLDEN0 = dict(temp=3.0, epair=-6.7733681, etotal=-2.2744931,
               press=-3.7033504)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once, and each worker's intra-op thread
    pool would otherwise claim every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_tag(x, valid, tag):
    return x[valid][np.argsort(tag[valid])]


def test_trajectory_matches_jax_sorted():
    """11 steps with every=5: plain steps, rebuild steps (wrap + local
    re-binning) and the final partial block of the static schedule.
    Tolerances as tests/test_sorted.py: positions atol 1e-11, etotal rel
    1e-12."""
    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64, every=5,
                      device="cpu")
    sim.setup()
    rows = sim.run(11)
    ref = jax_lj_melt_sim(cells=6, t_init=1.44, dtype=jnp.float64, every=5,
                          list_mode="sorted")
    ref.setup()
    ref_rows = ref.run(11)

    # the same grid, including the capacity grown by the overflow retry
    assert (dataclasses.asdict(sim.nl.params)
            == dataclasses.asdict(ref.nl.params))
    assert sim.nl.nbuilds == int(ref.nl.nbuilds) == 3
    st = sim.state
    x = _by_tag(st.x.numpy(), st.valid_mask.numpy(), st.tag.numpy())
    x_ref = _by_tag(np.asarray(ref.state.x), np.asarray(ref.state.valid_mask),
                    np.asarray(ref.state.tag))
    np.testing.assert_allclose(x, x_ref, atol=1e-11)
    assert rows[-1]["etotal"] == pytest.approx(ref_rows[-1]["etotal"],
                                               rel=1e-12)
    assert rows[0]["press"] == pytest.approx(ref_rows[0]["press"], rel=1e-12)


def test_golden_step0():
    sim = lj_melt_sim(cells=10, t_init=3.0, seed=87287, dtype=torch.float64,
                      device="cpu")
    sim.setup()
    row = sim.thermo()
    assert row["natoms"] == 4000
    assert row["temp"] == pytest.approx(GOLDEN0["temp"], abs=1e-9)
    assert row["epair"] == pytest.approx(GOLDEN0["epair"], abs=2e-7)
    assert row["etotal"] == pytest.approx(GOLDEN0["etotal"], abs=2e-7)
    assert row["press"] == pytest.approx(GOLDEN0["press"], abs=2e-6)
