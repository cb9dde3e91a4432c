"""PyTorch port, host state: presets, Box transforms, import hygiene, and
the list mode each pair style resolves to.

The same seeded inputs go through the JAX package and the port
(lammps_kokkos_port_tpu_torch); fp64 results must agree bit for bit.
"""

import json
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
from lammps_kokkos_port_tpu_torch.io.eam_reader import write_sutton_chen_funcfl
from lammps_kokkos_port_tpu_torch.models.forcefield import HybridOverlay
from lammps_kokkos_port_tpu_torch.models.pair_eam import make_eam_funcfl
from lammps_kokkos_port_tpu_torch.models.pair_lj import make_lj_cut
from lammps_kokkos_port_tpu_torch.models.pair_snap import make_snap
from lammps_kokkos_port_tpu_torch.models.pair_tersoff import make_tersoff
from lammps_kokkos_port_tpu_torch.models.pair_zbl import make_zbl
from lammps_kokkos_port_tpu_torch.presets import lj_melt_state
from lammps_kokkos_port_tpu_torch.runner import Simulation
from lammps_kokkos_port_tpu_torch.utils.units import get_units

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


SORTED_REFUSED = ("sorted mode needs a single-type lj/cut style, a "
                  "single-element EAM style or a three-body style")
# (style, list mode asked for) -> the mode taken, or the refusal's text
LIST_MODES = {
    ("lj", "auto"): "sorted", ("lj", "sorted"): "sorted",
    ("lj", "cell"): "cell",
    ("lj 2 types", "auto"): SORTED_REFUSED,
    ("lj 2 types", "sorted"): SORTED_REFUSED,
    ("lj 2 types", "cell"): "cell",
    ("eam", "auto"): "EAM in list mode 'auto' runs the exact-spline matrix",
    ("eam", "sorted"): "sorted", ("eam", "cell"): "cell",
    ("eam 2 elements", "auto"): SORTED_REFUSED,
    ("eam 2 elements", "sorted"): SORTED_REFUSED,
    ("eam 2 elements", "cell"): "cell mode needs a pair_terms style or a "
                                "single-element EAM style, not PairEAM",
    ("tersoff", "auto"): "sorted", ("tersoff", "sorted"): "sorted",
    ("tersoff", "cell"): "cell mode needs a pair_terms style or a "
                         "single-element EAM style, not PairTersoff",
    ("zbl", "auto"): "sorted", ("zbl", "sorted"): "sorted",
    ("zbl", "cell"): "cell mode needs a pair_terms style or a "
                     "single-element EAM style, not PairZBL",
    ("zbl+snap", "auto"): "sorted", ("zbl+snap", "sorted"): "sorted",
    ("zbl+snap", "cell"): "cell mode needs a pair_terms style or a "
                          "single-element EAM style, not HybridOverlay",
}


def _style(name, tmp_path):
    if name.startswith("lj"):
        nt = 2 if "2" in name else 1
        return make_lj_cut(nt, {(t, t): (1.0, 1.0) for t in range(1, nt + 1)},
                           2.5, dtype=torch.float64)
    if name.startswith("eam"):
        pot = str(tmp_path / "cu.eam")
        write_sutton_chen_funcfl(pot)
        nt = 2 if "2" in name else 1
        return make_eam_funcfl(nt, {t: pot for t in range(1, nt + 1)})
    if name.startswith("zbl"):
        zbl = make_zbl(1, 4.0, 4.8, ["74", "74"], get_units("metal"))
        if name == "zbl":
            return zbl
        from bench_port import decks

        conf = json.loads((REPO / "bench_port/configs/snap-w-fp64.json")
                          .read_text())
        decks.potential(conf, decks.CONFIGS, tmp_path)
        snap = make_snap(1, str(tmp_path / "W_2940_2017_2.snapcoeff"),
                         str(tmp_path / "W_2940_2017_2.snapparam"), ["W"])
        return HybridOverlay((zbl, snap))
    return make_tersoff(1, str(REPO / "bench_port/configs/Si.tersoff"),
                        ["Si"])


@pytest.mark.parametrize("name,mode", sorted(LIST_MODES))
def test_list_mode_follows_the_style(name, mode, tmp_path):
    """Each style's `force_paths` decides the list mode: the mode it runs
    in, or NotImplementedError naming why (never another engine)."""
    sim = Simulation(lj_melt_state(cells=4, dtype=torch.float64,
                                   device="cpu"),
                     _style(name, tmp_path), list_mode=mode)
    want = LIST_MODES[name, mode]
    if want in ("sorted", "cell"):
        sim._pick_list_mode()
        assert sim.list_mode == want
        assert want in sim.pair_style.force_paths.modes
    else:
        with pytest.raises(NotImplementedError, match=want):
            sim._pick_list_mode()
