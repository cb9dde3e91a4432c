"""Profiling entry points of the port, counterparts of the JAX package's
sorted-kernel scripts in benchmarks/prof/:

  `sorted_ablate` (prof_sorted_ablate.py): the step, the sorted kernels
      and their ablations (K7, P9) at the 32k deck;
  `plane_half` (prof_v3_32k.py, prof_v3_iso.py): the Newton-half plane
      kernel K8 and its forward-only ablation P10 at 32k and 1M atoms;
  `kernel_iso` (prof_kernel_iso.py): the Newton-half column pass split
      into assembly, forward and reverse costs (P5's five modes);
  `kernel_writeonce` (prof_kernel_writeonce.py): reactions written once
      per column and folded outside the kernel (P8) against the shipped
      pass;
  `halfv2` (prof_halfv2.py): the id-free column pass (P2), exact and
      approximate reciprocal, at two z chunks;
  `zchunk` (prof_zchunk.py): forward-only column passes (P11) at several
      z chunks.

Each runs with `python -m lammps_kokkos_port_tpu_torch.prof.<name>` on the
card, or `main(..., device="cpu")` at a small size on the CPU, and prints
the script's lines under the script's labels. `grid` builds their inputs,
`timing` their slope timer, `ablate_kernels` holds the P9 kernels and
`column_half_kernels` those of P2, P5, P8 and P11.
"""
