"""PyTorch port, the Newton-half column passes' launch surface on the CPU:
the z chunks each pass is compiled for (prof/column_half_kernels.ZB), the
bytes each pass's bound counts, the names its build log's registers are
reported under, and the other designs that prof/column_redesign builds
from this tree's csrc/lj_column_half.cu (each must still assemble, so an
edit to the source fails here and not first on the card).
"""

import pytest

from lammps_kokkos_port_tpu_torch.prof import column_half_kernels as chk
from lammps_kokkos_port_tpu_torch.prof import column_redesign

ID_FREE = {"halfv2", "halfv2_approx", "zchunk_fused"}


@pytest.mark.parametrize("name", sorted(chk.SPECS))
def test_z_chunks_are_validated(name):
    """None is the default block of four cells; every compiled chunk is
    taken as given; any other raises, on the CPU as on the card."""
    assert chk.cells_per_block(name) == chk.DEFAULT_ZB == 4
    for zb in chk.ZB[name]:
        assert chk.cells_per_block(name, zb) == zb
    for zb in (0, 5, 13):
        with pytest.raises(ValueError, match="is not compiled"):
            chk.cells_per_block(name, zb)


def test_z_chunks_are_the_entry_points():
    """prof.halfv2 asks for 2 and 4; prof.zchunk for nz (12 at the 20-cell
    melt, 3 at the 6-cell one), 4, 2 and 1; no other pass takes one."""
    assert chk.ZB["halfv2"] == chk.ZB["halfv2_approx"] == (2, 4)
    for name in ("zchunk_fwd", "zchunk_fused"):
        assert set(chk.ZB[name]) == {1, 2, 3, 4, 12}
    assert all(chk.ZB[n] == (4,) for n in chk.SPECS
               if not n.startswith(("halfv2", "zchunk")))


@pytest.mark.parametrize("name", sorted(chk.SPECS))
def test_bound_counts_inputs_and_outputs_only(name):
    """Each pass's bound moves its input planes once (x, y, z and, where
    its mask reads them, the ids) and its outputs once (three force
    planes; P8's rc, 15 more): at the 32k grid, (12, 12, 12) x cc 32 in
    f32, 7 planes take 0.000462 ms at 3.35 TB/s."""
    planes = chk.bound_planes(name)
    want = (6 if name in ID_FREE else 7) + (15 if name == "writeonce" else 0)
    assert planes == want
    rows = 12 ** 3 * 32
    ms = rows * planes * 4 / 3.35e12 * 1e3
    expected = {6: 0.000396, 7: 0.000462, 22: 0.001453}[planes]
    assert round(ms, 6) == expected


def test_instance_registers_name_each_kernel():
    """The build log's registers, in order, under each instance's
    template arguments (in the form cu++filt prints them) or its raw
    name."""
    log = "\n".join([
        "ptxas info    : Compiling entry function 'void <unnamed>::"
        "column_half_kernel<float, (<unnamed>::Mask)2, (bool)1, (<unnamed>"
        "::Land)3, (int)12>(<unnamed>::Args<T1>)' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "ptxas info    : Used 64 registers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function 'void <unnamed>::"
        "column_half_kernel<double, (<unnamed>::Mask)4, (bool)0, (<unnamed>"
        "::Land)1, (int)4>(<unnamed>::Args<T1>)' for 'sm_90a'",
        "ptxas info    : Used 56 registers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Zfold' for 'sm_90a'",
        "ptxas info    : Used 20 registers, 380 bytes cmem[0]"])
    assert chk.instance_registers(log) == [
        ("f32 slot approx target zb=12", 64),
        ("f64 unstaged row zb=4", 56), ("_Zfold", 20)]


@pytest.mark.parametrize("name", sorted(column_redesign.VARIANTS))
def test_column_redesign_variants_assemble(name, tmp_path):
    """Each other design is this tree's source with one line replaced:
    that line must be there once, and the headers beside it."""
    old, new, timed = column_redesign.VARIANTS[name]
    out = column_redesign.variant_source(tmp_path, old, new)
    text, original = out.read_text(), chk.SOURCE.read_text()
    assert original.count(old + "\n") == 1 and new + "\n" in text
    assert text == original.replace(old + "\n", new + "\n")
    assert set(timed) <= set(chk.SPECS)
    assert {p.name for p in tmp_path.glob("*.cuh")} == {
        p.name for p in chk.SOURCE.parent.glob("*.cuh")}


def test_parent_passes_cover_every_pass():
    """The earlier tree's pass numbers and buffers name every pass."""
    assert set(column_redesign.PARENT_PASSES) == set(chk.SPECS)



def test_parent_on_the_walk_is_recognised(tmp_path):
    """This tree's source has the walk's entry points; a first-design
    source (no ColumnGrid) is launched through its own."""
    assert column_redesign.on_walk(chk.SOURCE)
    old = tmp_path / chk.SOURCE.name
    old.write_text(chk.SOURCE.read_text().replace("struct ColumnGrid",
                                                  "struct OtherGrid"))
    assert not column_redesign.on_walk(old)
