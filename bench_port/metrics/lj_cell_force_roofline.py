"""Percent of its roofline one call of lj_cell_force reaches in the traced runs
(roofline/kernels/lj_cell_force.json; the end state's counts)."""

from bench_port.roofline import peaks


def read(ctx, name):
    return peaks.kernel_share("lj_cell_force", ctx["trace"], ctx["counts"],
                              ctx["dtype"])
