"""PyTorch/CUDA port of `lammps_kokkos_port_tpu` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's module names (`core/`, `models/`,
`ops/`, `integrate/`, `compute/`, `runner.py`, `presets.py`), so each
module's counterpart is easy to find. The JAX package is the reference the
port is tested against; this package never imports it, nor jax.

The first slice covers the LJ-melt main path (`presets.lj_melt_sim` ->
`runner.Simulation` in the cell-major "sorted" list mode -> the fused NVE
segment -> the hand-written CUDA pair-force kernel in
`ops/pair_kernels.py` + `csrc/lj_cell_force.cu`). The second covers the
EAM deck (`presets.eam_bulk_cu_sim(list_mode="sorted")` -> the generic
step with its on-device rebuild decision -> the two CUDA EAM sweeps in
`ops/eam_kernels.py` + `csrc/eam_cell.cu`). Importing the package imports
no submodule; import what you use, e.g.
`from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim`.
"""
