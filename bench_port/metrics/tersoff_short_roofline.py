"""Percent of its roofline one call of tersoff_short reaches in the traced
runs (roofline/kernels/tersoff_short.json; the end state's counts)."""

from bench_port.roofline import peaks


def read(ctx, name):
    return peaks.kernel_share("tersoff_short", ctx["trace"], ctx["counts"],
                              ctx["dtype"])
