"""PyTorch port, prof/full_redesign's surface on the CPU: its argument
checks (the earlier tree's directory and sources, the timing counts, both
raised before any card is asked for), the earlier tree's entry points it
binds for every contender (each present in this tree's sources, whose C
entry points it shares), the other design it builds from this tree's
csrc/lj_ablate.cu (it must still assemble, so an edit to the source
fails here and not first on the card), and the live inputs of its pair
ablations.
"""

import shutil

import pytest
import torch

from lammps_kokkos_port_tpu_torch.ops import cuda_build
from lammps_kokkos_port_tpu_torch.prof import ablate_kernels as ak
from lammps_kokkos_port_tpu_torch.prof import full_redesign as fr
from lammps_kokkos_port_tpu_torch.prof.grid import SortedPlanes


def _parent_dir(tmp_path, skip=()):
    for src in cuda_build.CSRC.iterdir():
        if src.name not in skip:
            shutil.copy(src, tmp_path / src.name)
    return tmp_path


def test_parent_entries_name_every_contender():
    """Every contender has an earlier-tree entry point, and each named C
    function is one this tree's source still exports (the signatures are
    shared); pair_only_approx exists in f32 only."""
    contenders = {*fr.COLUMN, *fr.AT_1M, "pair_only", "pair_only_approx",
                  "P4", "asm_only"}
    assert set(fr.PARENT_ENTRIES) == contenders
    for name, (src, stem, _, dts) in fr.PARENT_ENTRIES.items():
        text = fr.SOURCES[src].read_text()
        for dt in dts:
            assert f"{stem}_{dt}" in text, (name, stem, dt)
    assert fr.PARENT_ENTRIES["pair_only_approx"][3] == ("f32",)
    assert "lj_pair_only_approx_f64" not in ak.SOURCE.read_text()


def test_parent_sources_are_checked(tmp_path):
    """--parent must be a directory holding every source and the headers;
    a missing one is named."""
    with pytest.raises(FileNotFoundError, match="not a directory"):
        fr.parent_sources(tmp_path / "absent")
    parent = _parent_dir(tmp_path, skip=("lj_ablate.cu",))
    with pytest.raises(FileNotFoundError, match="lj_ablate.cu"):
        fr.parent_sources(parent)
    shutil.copy(ak.SOURCE, parent / ak.SOURCE.name)
    got = fr.parent_sources(parent)
    assert got == {name: parent / name for name in fr.SOURCES}


def test_headers_are_required(tmp_path):
    for name, src in fr.SOURCES.items():
        shutil.copy(src, tmp_path / name)
    with pytest.raises(FileNotFoundError, match="headers"):
        fr.parent_sources(tmp_path)


@pytest.mark.parametrize("rounds,inner", [(0, 20), (5, 0), (-1, -1)])
def test_counts_are_checked_before_the_card(tmp_path, rounds, inner):
    with pytest.raises(ValueError, match="rounds and inner"):
        fr.main(str(_parent_dir(tmp_path)), rounds=rounds, inner=inner)


def test_missing_parent_raises_before_the_card(tmp_path):
    with pytest.raises(FileNotFoundError):
        fr.main(str(tmp_path / "absent"))


@pytest.mark.parametrize("name", sorted(fr.VARIANTS))
def test_variants_assemble(name, tmp_path):
    """Each other design is this tree's lj_ablate.cu with one line
    replaced: that line must be there once, and the headers beside it;
    it is timed only for pair contenders."""
    old, new, timed = fr.VARIANTS[name]
    out = fr.variant_source(tmp_path, old, new)
    text, original = out.read_text(), ak.SOURCE.read_text()
    assert original.count(old + "\n") == 1 and new + "\n" in text
    assert text == original.replace(old + "\n", new + "\n")
    assert set(timed) <= {"pair_only", "pair_only_approx", "P4"}
    assert {p.name for p in tmp_path.glob("*.cuh")} == {
        p.name for p in cuda_build.CSRC.glob("*.cuh")}


def test_lane_counts():
    """P4's 512 lanes, and twice the 14 * cc = 448 of the 32k melt."""
    assert fr.P4_LANES == 512
    assert fr.WIDE_LANES == 2 * 14 * 32
    assert fr.LANE_RATIO_MIN == 1.8


def test_live_inputs():
    """chip_smoke.py's live pair_only inputs: each position 3 +- [0.8,
    1.6], ids -1..2 by row, on the planes' grid, from a seed."""
    ncells, cc = (3, 3, 3), 4
    cap = 27 * cc
    sp = SortedPlanes(ncells=ncells, cc=cc, natoms=0,
                      key=("lj", 48.0, 24.0, 6.25),
                      prd=torch.full((3,), 9.0), buf=torch.zeros(4, cap))
    live = fr.live_inputs(sp)
    assert all(a.shape == (27, cc) for a in live)
    off = torch.stack([(a - 3.0).abs() for a in live[:3]])
    assert bool((off >= 0.8).all()) and bool((off <= 1.6).all())
    assert live[3].reshape(-1)[:5].tolist() == [-1.0, 0.0, 1.0, 2.0, -1.0]
    again = fr.live_inputs(sp)
    assert all(torch.equal(a, b) for a, b in zip(live, again))
