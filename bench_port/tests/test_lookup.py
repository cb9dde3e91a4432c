"""A configuration enters the benchmark as new files only, and the three
cells read what they read before the lookups.

- Pinned values: box lengths and atoms of every configuration and mix, the
  reference's forces, energy and virial on a seeded state of lj/cut and
  eam, the potential writer's bytes, and the kernels' work, bounds and
  readers, each bit for bit as they were before the lookups by name.
- A whole configuration built in a temporary directory: lj/cut on a bcc
  lattice, a potential data file the deck includes, a reference module and
  a kernel file with `triplet_ops`, found through the lookup directories,
  run through `harness.run_cell` on the CPU.
- Unknown names raise, naming what was missing.

    python -m pytest bench_port/tests -q
"""

import hashlib
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import check, decks, harness
from bench_port.reference.models import REF
from bench_port.reference.neighbors import work_counts
from bench_port.roofline import peaks
from bench_port.tests.test_yardstick import BENCH, ROOT, check_deck

CONFIGS = ("lj-melt", "eam-cu", "eam-cu-fp64")
MIXES = ("published-32k", "scaled-32x")
KERNELS = ("lj_cell_force", "eam_cell_rho", "eam_cell_force")
LJ_BOX = 33.59192382765015      # 20 fcc cells at 0.8442
CU_BOX = 72.30000000000001      # 20 fcc cells of 3.615 A
PINNED_BOX = {
    "lj-melt": {"published-32k": [LJ_BOX] * 3,
                "scaled-32x": [134.3676953106006, 67.1838476553003,
                               134.3676953106006]},
    "eam-cu": {"published-32k": [CU_BOX] * 3,
               "scaled-32x": [289.20000000000005, 144.60000000000002,
                              289.20000000000005]},
}
PINNED_BOX["eam-cu-fp64"] = PINNED_BOX["eam-cu"]
PINNED_ATOMS = {"published-32k": 32000, "scaled-32x": 1024000}
# the reference on `lattice_state(config, cells, seed)`: n, pe, virial,
# summed |virial|, sha256 of the float64 forces and of the band
PINNED_REF = {
    "lj-melt": (6, 11, 864, -4053.554640218274, [
        3360.892399119677, 4159.201476322044, 3581.9660200322724,
        33.92242938174911, -167.3316995518471, 32.946794515604324],
        43282.7928941889,
        "ed146de97e79b6952006314d943e285f790df487698dd394e636d4bc19803485",
        "f2a5f975909d6c8a170da11710c33d01749cf9410dd5d420e33eb329fab65d2e"),
    "eam-cu": (5, 12, 500, -1281.6220527998146, [
        1093.0124724120415, 1093.812240565865, 1219.351537198614,
        27.31826114406431, -14.452286567793472, 131.66387341785887],
        4691.654234320462,
        "e306bc3a6c72aae6bd9f7b8fe347552c12451626eb61bc01fc9a6eb700e8c59c",
        "73bebddbead70fd1a3411a8852ad5a3403254cd0d60070604d35ba6f050efc9a"),
}
PINNED_POTENTIAL = (
    "550553f1f4a5eabfcc545df78b97c67f9b23af4391e064f5e8760aeabed16bd5")
# kernel: (operations and operation-bound seconds at 28.3M pairs and
# 1,024,000 atoms, f32 and f64; byte-bound seconds at 100,000 pairs)
PINNED_WORK = {
    "lj_cell_force": (707500000, 1.0559701492537313e-05,
                      2.0808823529411766e-05, 7.3361194029850746e-06,
                      1.4672238805970149e-05),
    "eam_cell_rho": (3141576000, 4.6889194029850744e-05,
                     9.239929411764706e-05, 6.41910447761194e-06,
                     1.2532537313432836e-05),
    "eam_cell_force": (5546800000, 8.278805970149254e-05,
                       0.00016314117647058823, 8.558805970149254e-06,
                       1.711761194029851e-05),
}
# readers on a fixed context: (kernels, dtype) -> {metric: value}
PINNED_READERS = {
    (("lj_cell_force",), "float32"): {
        "step_mfu": 0.11180860403863038,
        "lj_cell_force_roofline": 1.0559701492537314},
    (("eam_cell_rho", "eam_cell_force"), "float64"): {
        "step_mfu": 2.705722629757785,
        "eam_cell_rho_roofline": 9.239929411764706,
        "eam_cell_force_roofline": 8.157058823529411},
}
BIG = {"pairs": 28_300_000, "atoms": 1_024_000}


@pytest.fixture(autouse=True)
def one_thread():
    # the pinned sums are bit for bit: one thread fixes their order
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config_of(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def mix_of(name):
    return json.loads((ROOT / "mixes" / f"{name}.json").read_text())


def lattice_state(config, cells, seed):
    """A cubic box of `cells` fcc cells a side, each atom moved by a seeded
    normal step of 0.05 lattice constants: (mix, positions)."""
    mix = {"vars": {v: cells / 20 for v in "xyz"}}
    prd = torch.tensor(decks.box_lengths(config, mix), dtype=torch.float64)
    a = float(prd[0]) / cells
    fcc = torch.tensor([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]],
                       dtype=torch.float64)
    g = torch.stack(torch.meshgrid(
        *[torch.arange(cells, dtype=torch.float64)] * 3, indexing="ij"),
        -1).reshape(-1, 1, 3)
    x = ((g + fcc) * a).reshape(-1, 3)
    gen = torch.Generator().manual_seed(seed)
    return mix, x + 0.05 * a * torch.randn(x.shape, generator=gen,
                                           dtype=torch.float64)


def sha(t):
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_pinned_box_and_atoms(name):
    for mix in MIXES:
        assert decks.box_lengths(config_of(name), mix_of(mix)) == \
            PINNED_BOX[name][mix]
        assert decks.atoms(config_of(name), mix_of(mix)) == PINNED_ATOMS[mix]


@pytest.mark.parametrize("name", sorted(PINNED_REF))
def test_pinned_reference(name, tmp_path):
    cells, seed, n, pe, virial, vabs, f_sha, band_sha = PINNED_REF[name]
    config = config_of(name)
    pot = decks.potential(config, decks.CONFIGS, tmp_path)
    if pot is not None:
        assert hashlib.sha256(Path(pot).read_bytes()).hexdigest() == \
            PINNED_POTENTIAL
    mix, x = lattice_state(config, cells, seed)
    system = check.system_for(config, mix, "cpu", pot)
    res = system.forces(x, REF, energy=True)
    assert x.shape[0] == n
    assert (res.pe, res.virial, res.virial_abs) == (pe, virial, vabs)
    assert (sha(res.f), sha(res.band)) == (f_sha, band_sha)


@pytest.mark.parametrize("kernel", KERNELS)
def test_pinned_kernel_work(kernel):
    ops, b32, b64, bytes32, bytes64 = PINNED_WORK[kernel]
    assert peaks.work_ops(kernel, BIG) == ops
    for dtype, want in (("float32", b32), ("float64", b64)):
        assert peaks.kernel_bound(kernel, BIG, dtype) == {
            "bound_s": want, "bound_by": "operations"}
    small = {"pairs": 100_000, "atoms": 1_024_000}
    for dtype, want in (("float32", bytes32), ("float64", bytes64)):
        assert peaks.kernel_bound(kernel, small, dtype) == {
            "bound_s": want, "bound_by": "bytes"}
    assert not peaks.needs_triplets([kernel])


@pytest.mark.parametrize("key", sorted(PINNED_READERS))
def test_pinned_readers(key):
    kernels, dtype = key
    ctx = {"counts": BIG, "kernels": list(kernels), "dtype": dtype,
           "window": {"wall_s": 51.0, "steps": 5400},
           "trace": {"kernels": {k: {"total_s": 3e-3 * (i + 1), "calls": 3}
                                 for i, k in enumerate(kernels)}}}
    for metric, want in PINNED_READERS[key].items():
        assert harness.reader(metric + ".1m")(ctx, metric + ".1m") == want


def test_lattice_bases_are_the_ports():
    from lammps_kokkos_port_tpu_torch.core.lattice import _BASES

    for style, n in decks.BASIS.items():
        assert len(_BASES[style]) == n
        config = {"units": "lj", "lattice": {"style": style, "scale": 0.5},
                  "cells_per_var": [3, 4, 5]}
        mix = {"vars": {"x": 1, "y": 1, "z": 2}}
        assert decks.atoms(config, mix) == n * 3 * 4 * 10
        a = (n / 0.5) ** (1 / 3)
        assert decks.box_lengths(config, mix) == [3 * a, 4 * a, 10 * a]
        config["units"] = "metal"
        assert decks.box_lengths(config, mix) == [1.5, 2.0, 5.0]


# ---- a configuration added as files: lj/cut on bcc, in a temporary tree

BCC_DECK = """# lj/cut on a bcc lattice, its pair_coeff in a data file
variable        x index 1
variable        y index 1
variable        z index 1

variable        xx equal 7*$x
variable        yy equal 7*$y
variable        zz equal 7*$z

units           lj
atom_style      atomic

lattice         bcc 0.8442
region          box block 0 ${xx} 0 ${yy} 0 ${zz}
create_box      1 box
create_atoms    1 box
mass            1 1.0

velocity        all create 1.44 87287 loop geom

pair_style      lj/cut 2.5
include         lj-bcc.coeff

neighbor        0.3 bin
neigh_modify    delay 0 every 20 check no

fix             1 all nve

run             100
"""
BCC_CONFIG = {
    "name": "lj-bcc", "deck": "lj-bcc.in", "dtype": "float32",
    "list_mode": "auto", "units": "lj",
    "lattice": {"style": "bcc", "scale": 0.8442}, "cells_per_var": [7, 7, 7],
    "mass": 1.0,
    "pair": {"style": "lj/cut", "file_token": "lj-bcc.coeff",
             "epsilon": 1.0, "sigma": 1.0, "cutoff": 2.5},
    "potential": {"file": "lj-bcc.coeff"},
    "velocity": {"temp": 1.44, "seed": 87287, "loop": "geom"},
    "neighbor": {"skin": 0.3, "every": 20, "delay": 0, "check": False},
    "timestep": 0.005, "thermo": 0, "run": 100,
    "kernels": {"lj_cell_force":
                "lammps_kokkos_port_tpu_torch.ops.pair_kernels"},
    "reference_skin": 0.6,
}
# the reference module reads its parameters from the run's potential file
BCC_REFERENCE = '''"""lj/cut with epsilon, sigma and cutoff from the pair_coeff line of
the run's potential file."""

from bench_port.reference.models import LJ


def build(config, potential_path, band):
    words = open(potential_path).read().split()
    eps, sigma, cut = (float(v) for v in words[3:6])
    return LJ(eps, sigma, cut, band), config["mass"]
'''
TRIPLET_OPS = 7


def tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.stat().st_mtime_ns
            for p in root.rglob("*") if "__pycache__" not in p.parts}


@pytest.fixture
def new_config(tmp_path, monkeypatch):
    """The lj-bcc configuration's files in a temporary tree, with the
    reference, kernel-work and limits lookups pointed there."""
    configs, ref, kern, limits = (tmp_path / d for d in (
        "configs", "reference", "kernels", "limits"))
    for d in (configs, ref, kern, limits):
        d.mkdir()
    (configs / "lj-bcc.json").write_text(json.dumps(BCC_CONFIG))
    (configs / "lj-bcc.in").write_text(BCC_DECK)
    (configs / "lj-bcc.coeff").write_text("pair_coeff 1 1 1.0 1.0 2.5\n")
    (ref / "pair_lj_cut.py").write_text(BCC_REFERENCE)
    work = json.loads((peaks.KERNELS / "lj_cell_force.json").read_text())
    (kern / "lj_cell_force.json").write_text(json.dumps(
        {**work, "triplet_ops": TRIPLET_OPS}))
    (limits / "lj-bcc.tiny.json").write_text(
        (check.LIMITS / "lj-melt.32k.json").read_text())
    monkeypatch.setattr(check, "REFERENCE", ref)
    monkeypatch.setattr(check, "LIMITS", limits)
    monkeypatch.setattr(peaks, "KERNELS", kern)
    return configs


def test_a_configuration_added_as_files(new_config):
    before = tree(ROOT)
    entry = {"name": "lj-bcc.tiny", "config": "lj-bcc", "traffic": "tiny",
             "chips": 1, "why": "test"}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(entry)
    next(m for m in bench["end_to_end"] if m["name"] ==
         "atom_steps_per_s.32k")["workloads"].append(entry["name"])
    config = json.loads((new_config / "lj-bcc.json").read_text())
    mix = {"name": "tiny", "vars": {"x": 1, "y": 1, "z": 1}}
    # the deck with its included data file
    check_deck(config, (new_config / config["deck"]).read_text()
               + (new_config / "lj-bcc.coeff").read_text())
    assert decks.atoms(config, mix) == 2 * 7 ** 3

    cell = decks.Cell(entry["name"], entry, config, mix, bench, new_config)
    res = harness.run_cell(cell, 2**31 + 77, 0.2, False, "cpu",
                           time.perf_counter())
    limits = json.loads((ROOT / "limits" / "lj-melt.32k.json").read_text())
    for name in check.NUMBERS:
        value = res["checks"][name]["value"]
        assert math.isfinite(value) and value <= limits[name]["limit"], (
            name, value)
    assert res["correct"], res["checks"]
    for name in ("atom_steps_per_s.32k", "setup_s"):
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0
    assert tree(ROOT) == before  # nothing written under bench_port/


def brute_triplets(x, prd, cut):
    d = x[:, None, :] - x[None, :, :]
    d = d - prd * np.round(d / prd)
    near = (d * d).sum(-1) < cut * cut
    np.fill_diagonal(near, False)
    return sum(len(js) * (len(js) - 1) for js in
               (np.nonzero(row)[0] for row in near))


def test_triplets_counted_where_a_kernel_names_them(new_config):
    config = json.loads((new_config / "lj-bcc.json").read_text())
    assert peaks.needs_triplets(config["kernels"])
    mix = {"vars": {"x": 1, "y": 1, "z": 1}}
    prd = np.array(decks.box_lengths(config, mix))
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, size=(decks.atoms(config, mix), 3)) * prd
    counts = work_counts(torch.tensor(x), torch.tensor(prd), 2.5,
                         peaks.needs_triplets(config["kernels"]))
    assert counts["triplets"] == brute_triplets(x, prd, 2.5) > 0
    assert peaks.work_ops("lj_cell_force", counts) == (
        25 * counts["pairs"] + TRIPLET_OPS * counts["triplets"])
    with pytest.raises(KeyError):
        peaks.work_ops("lj_cell_force", {"pairs": 1, "atoms": 1})


# ---- unknown names

def test_unknown_names_raise(tmp_path):
    config = config_of("lj-melt")
    with pytest.raises(FileNotFoundError, match="pair_tersoff.py"):
        check.system_for({**config, "pair": {"style": "tersoff"}},
                         mix_of("published-32k"), "cpu")
    with pytest.raises(ValueError, match="'hcp'"):
        decks.box_lengths({**config, "lattice": {"style": "hcp",
                                                 "scale": 1.0}},
                          mix_of("published-32k"))
    with pytest.raises(ValueError, match="'hcp'"):
        decks.atoms({**config, "lattice": {"style": "hcp", "scale": 1.0}},
                    mix_of("published-32k"))
    pair = {"style": "eam", "file_token": "x.eam"}
    with pytest.raises(FileNotFoundError, match="no-such-kind.py"):
        decks.potential({"pair": pair, "potential": {"kind": "no-such-kind"}},
                        decks.CONFIGS, tmp_path)
    with pytest.raises(FileNotFoundError, match="no-such.eam"):
        decks.potential({"pair": pair, "potential": {"file": "no-such.eam"}},
                        decks.CONFIGS, tmp_path)
    with pytest.raises(FileNotFoundError, match="no-such-metric"):
        harness.reader("no-such-metric.1m")
