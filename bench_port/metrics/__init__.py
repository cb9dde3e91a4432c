"""Per-layer metrics, one reader a file: `metrics/<name>.py` holds
`read(ctx, name)`, which returns the metric's value from the run's context
(`harness.reader_context`) or None where it finds nothing to read. A
metric `a.b.c` is read by the first of `a.b.c.py`, `a.b.py`, `a.py` that
exists, so one reader serves each size suffix."""
