"""Per-layer metrics, one reader a file: `metrics/<name>.py` holds
`read(ctx, name)`, which returns the metric's value from the run's context
(built in `harness.run_cell`: `dtype`, `kernels`, `build_s`, `sim_s`,
`window`, `trace` and `counts`) or None where it finds nothing to read. A
metric `a.b.c` is read by the first of `a.b.c.py`, `a.b.py`, `a.py` that
exists, so one reader serves each size suffix."""
