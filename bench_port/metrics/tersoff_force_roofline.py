"""Percent of its roofline one call of tersoff_force reaches in the traced
runs (roofline/kernels/tersoff_force.json; the end state's counts, pairs
and triplets within R + D)."""

from bench_port.roofline import peaks


def read(ctx, name):
    return peaks.kernel_share("tersoff_force", ctx["trace"], ctx["counts"],
                              ctx["dtype"])
