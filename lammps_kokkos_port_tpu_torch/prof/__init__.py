"""Profiling entry points of the port, counterparts of the JAX package's
sorted-kernel scripts in benchmarks/prof/:

  `sorted_ablate` (prof_sorted_ablate.py): the step, the sorted kernels
      and their ablations (K7, P9) at the 32k deck;
  `plane_half` (prof_v3_32k.py, prof_v3_iso.py): the Newton-half plane
      kernel K8 and its forward-only ablation P10 at 32k and 1M atoms.

Each runs with `python -m lammps_kokkos_port_tpu_torch.prof.<name>` on the
card, or `main(..., device="cpu")` at a small size on the CPU, and prints
the script's lines under the script's labels. `grid` builds their inputs,
`timing` their slope timer, `ablate_kernels` holds the P9 kernels.
"""
