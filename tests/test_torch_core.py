"""PyTorch port, host state: presets, Box transforms and import hygiene.

The same seeded inputs go through the JAX package and the port
(lammps_kokkos_port_tpu_torch); fp64 results must agree bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu.core.box import Box as JaxBox
from lammps_kokkos_port_tpu.presets import lj_melt_pair as jax_lj_melt_pair
from lammps_kokkos_port_tpu.presets import lj_melt_state as jax_lj_melt_state
from lammps_kokkos_port_tpu_torch import interop
from lammps_kokkos_port_tpu_torch.core.box import Box
from lammps_kokkos_port_tpu_torch.presets import lj_melt_state

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lj_melt_state_bit_exact(dtype):
    ref = jax_lj_melt_state(cells=6, t_init=1.44, dtype=getattr(jnp, dtype))
    got = lj_melt_state(cells=6, t_init=1.44, dtype=getattr(torch, dtype),
                        device="cpu")
    for k in ("x", "v", "type", "tag", "mask"):
        a = np.asarray(getattr(ref, k))
        b = getattr(got, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert got.nlocal == int(ref.nlocal) == 864


def test_interop_round_trip():
    ref = jax_lj_melt_state(cells=6, dtype=jnp.float64)
    st = interop.state_from_arrays(interop.dataclass_to_arrays(ref))
    back = interop.state_to_arrays(st)
    for k in ("x", "v", "f", "type", "tag", "image", "mask", "mass"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(ref, k)))
    np.testing.assert_array_equal(back["box"]["hi"], np.asarray(ref.box.hi))
    assert back["nlocal"] == 864

    jpair = jax_lj_melt_pair(dtype=jnp.float64)
    pair = interop.pair_from_arrays(interop.dataclass_to_arrays(jpair))
    assert pair.kernel_key() == jpair.kernel_key()
    pback = interop.pair_to_arrays(pair)
    for k in ("lj1", "lj2", "lj3", "lj4", "cutsq", "offset"):
        np.testing.assert_array_equal(pback[k], np.asarray(getattr(jpair, k)))


@pytest.mark.parametrize("periodic", [(True, True, True),
                                      (True, False, True)])
def test_box_ops_match_jax(periodic):
    rng = np.random.default_rng(7)
    lo = np.array([-1.5, 0.25, 2.0])
    hi = lo + np.array([7.3, 5.1, 9.9])
    jb = JaxBox.create(lo, hi, periodic=periodic, dtype=jnp.float64)
    tb = Box.create(lo, hi, periodic=periodic, dtype=torch.float64)
    pts = rng.uniform(lo - 1.5 * (hi - lo), hi + 1.5 * (hi - lo), (512, 3))
    img = rng.integers(-3, 4, (512, 3)).astype(np.int32)
    disp = rng.uniform(-(hi - lo), hi - lo, (512, 3))

    np.testing.assert_array_equal(
        tb.to_lamda(torch.from_numpy(pts)).numpy(),
        np.asarray(jb.to_lamda(jnp.asarray(pts))))
    xw, iw = tb.wrap(torch.from_numpy(pts), torch.from_numpy(img))
    jxw, jiw = jb.wrap(jnp.asarray(pts), jnp.asarray(img))
    np.testing.assert_array_equal(xw.numpy(), np.asarray(jxw))
    np.testing.assert_array_equal(iw.numpy(), np.asarray(jiw))
    np.testing.assert_array_equal(
        tb.min_image(torch.from_numpy(disp)).numpy(),
        np.asarray(jb.min_image(jnp.asarray(disp))))
    with pytest.raises(NotImplementedError):
        Box.create(lo, hi, tilt=(0.5, 0.0, 0.0))


def test_port_import_leaves_jax_out():
    """Importing every module of the port must not import jax or the JAX
    package (run in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import lammps_kokkos_port_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'lammps_kokkos_port_tpu'))\n"
        "assert 'lammps_kokkos_port_tpu_torch.runner' in new\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
