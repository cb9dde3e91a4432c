"""PyTorch port, the shared nvcc build helper (ops/cuda_build) on CPU.

No nvcc is needed: these check how libraries are named and found. A
library's name carries a hash of its source, of the headers beside it and
of the flags, so an edited source or header builds anew; a library already
on disk is loaded as it is, with its compiler log.
"""

from lammps_kokkos_port_tpu_torch.ops import (cell_kernels, cuda_build,
                                              eam_kernels, pair_kernels)


def test_library_name_follows_source_and_headers(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\nint a;\n')
    first = cuda_build.lib_path(src)
    assert first.parent == cuda_build.BUILD_DIR
    assert first.name.startswith("libk-") and first.suffix == ".so"
    assert cuda_build.lib_path(src) == first  # deterministic

    src.write_text('#include "h.cuh"\nint b;\n')
    second = cuda_build.lib_path(src)
    assert second != first

    (tmp_path / "h.cuh").write_text("#pragma once\n")
    third = cuda_build.lib_path(src)
    assert third != second
    (tmp_path / "h.cuh").write_text("#pragma once\nint c;\n")
    assert cuda_build.lib_path(src) != third


def test_built_library_is_reused(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "k.cu"
    src.write_text("int a;\n")
    lib = cuda_build.lib_path(src)
    lib.parent.mkdir()
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info: Used 40 registers\n")
    # on disk already: no compiler is started
    assert cuda_build.build(src) == {"k.cu": "ptxas info: Used 40 registers\n"}


def test_each_kernel_module_has_its_own_source():
    sources = {pair_kernels.SOURCE, eam_kernels.SOURCE, cell_kernels.SOURCE}
    assert len(sources) == 3
    assert all(s.parent == cuda_build.CSRC and s.exists() for s in sources)
    assert len({cuda_build.lib_path(s) for s in sources}) == 3
