"""PyTorch port, the EAM slice end to end on CPU against JAX.

bench/in.eam (`neigh_modify every 1 delay 5 check yes`) on the dense
path: the port's `eam_bulk_cu_sim(list_mode="sorted")` (generic step with
the on-device rebuild decision, plain twins of the two CUDA sweeps)
against the JAX sim with `_list_mode_req = "sorted"` (its generic
`make_step` with the `lax.cond` rebuild, Pallas sweeps in interpret mode).
Both read the synthetic Sutton-Chen stand-in for bench/Cu_u3.eam, written
into a temporary directory. nbuilds equal and above 1 holds the
distance-checked rebuild schedule itself. fp64; thermo rel 1e-10,
positions by tag atol 1e-9 (the sweeps sum in another order than the
Newton-halved Pallas kernels).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.presets import (
    eam_bulk_cu_sim as jax_eam_bulk_cu_sim,
)
from lammps_kokkos_port_tpu_torch.io.eam_reader import (
    write_sutton_chen_funcfl,
)
from lammps_kokkos_port_tpu_torch.ops import eamdense
from lammps_kokkos_port_tpu_torch.presets import eam_bulk_cu_sim
from lammps_kokkos_port_tpu_torch.script import LammpsScript

THERMO_KEYS = ("temp", "epair", "ke", "pe", "etotal", "press", "pxx", "pyy",
               "pzz", "pxy", "pxz", "pyz")


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


@pytest.fixture(scope="module")
def pot(tmp_path_factory):
    return write_sutton_chen_funcfl(tmp_path_factory.mktemp("eam") / "sc.eam")


@pytest.fixture(scope="module")
def jax_ref(pot):
    """The JAX sorted-mode run: 20 steps, a row every 10."""
    ref = jax_eam_bulk_cu_sim(cells=6, dtype=jnp.float64, potential_path=pot)
    ref._list_mode_req = "sorted"
    ref.setup()
    return ref, ref.run(20, thermo_every=10)


def test_eam_slice_matches_jax(pot, jax_ref, monkeypatch):
    builds = []
    build_poly_tables = eamdense.build_poly_tables

    def counted(style):
        builds.append(style)
        return build_poly_tables(style)

    monkeypatch.setattr(eamdense, "build_poly_tables", counted)
    sim = eam_bulk_cu_sim(cells=6, dtype=torch.float64, potential_path=pot,
                          list_mode="sorted")
    sim.setup()
    rows = sim.run(20, thermo_every=10)

    ref, ref_rows = jax_ref

    assert (dataclasses.asdict(sim.nl.params)
            == dataclasses.asdict(ref.nl.params))
    assert sim.nl.nbuilds == int(ref.nl.nbuilds) > 1
    assert [r["step"] for r in rows] == [0, 10, 20]
    for row, ref_row in zip(rows, ref_rows):
        for k in THERMO_KEYS:
            assert row[k] == pytest.approx(ref_row[k], rel=1e-10), k
    np.testing.assert_allclose(_by_tag(sim.state), _by_tag(ref.state),
                               rtol=0, atol=1e-9)
    # the Chebyshev tables were built once (setup), not on every step
    assert len(builds) == 1


EAM_DECK = """
units           metal
atom_style      atomic
lattice         fcc 3.615
region          box block 0 6 0 6 0 6
create_box      1 box
create_atoms    1 box
pair_style      eam
pair_coeff      1 1 POTENTIAL
velocity        all create 1600.0 376847 loop geom
neighbor        1.0 bin
neigh_modify    every 1 delay 5 check yes
fix             1 all nve
timestep        0.005
thermo          10
run             20
"""


@pytest.mark.parametrize("mode", ["sorted", "cell"])
def test_eam_deck_matches_jax(pot, jax_ref, mode):
    """bench/in.eam's commands at 864 atoms through the port's
    LammpsScript (metal units, the mass from the potential file, timestep,
    `check yes`), in list modes "sorted" and "cell" (EAM on the cell
    buckets: the plain roll path read through the buckets), against the
    same system's JAX sorted run. It shares that run, and its interpret-mode
    compiles, with the test above."""
    ref, ref_rows = jax_ref
    s = LammpsScript(dtype=torch.float64, list_mode=mode)
    rows = []
    emit = s._emit_thermo_row
    s._emit_thermo_row = lambda *a: rows.append(emit(*a)) or rows[-1]
    for line in EAM_DECK.replace("POTENTIAL", str(pot)).strip().splitlines():
        s.one(line)
    assert s.sim.list_mode == mode
    assert s.sim.nl.nbuilds == int(ref.nl.nbuilds) > 1
    assert [r["step"] for r in rows] == [0, 10, 20]
    for row, ref_row in zip(rows, ref_rows):
        for k in ("temp", "epair", "etotal", "press"):
            assert row[k] == pytest.approx(ref_row[k], rel=1e-10), k
    assert s._log_lines[0] == "Step Temp E_pair E_mol TotEng Press"
