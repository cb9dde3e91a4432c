"""Benchmark of the PyTorch/CUDA port (`lammps_kokkos_port_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json` (a configuration under `configs/`
driven by a mix under `mixes/`) through the port's deck front end and
`runner.Simulation.run`, and prints one JSON result line. Everything that
decides a number lives here: the deck generator (`decks.py`), the trace
reduction (`trace.py`), the roofline tables (`roofline/`), the per-layer
readers (`metrics/`), the float64 plain-PyTorch reference (`reference/`)
and the comparison that decides `correct` (`check.py`, limits in
`limits/`). Nothing here imports jax or the JAX package.

A configuration enters as new files only: its JSON and deck (and any
potential data file) under `configs/`, a mix under `mixes/` where it needs
one, a potential writer `potentials/<kind>.py`, a reference module
`reference/pair_<style>.py`, kernel work files `roofline/kernels/`, readers
`metrics/`, limits `limits/<cell>.json` and its entries in
`BENCHMARK.json`; `lookup.py` finds each by name.
"""
