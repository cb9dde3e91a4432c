"""Percent of its roofline one call of eam_cell_force reaches in the traced runs
(roofline/kernels/eam_cell_force.json; the end state's counts)."""

from bench_port.roofline import peaks


def read(ctx, name):
    return peaks.kernel_share("eam_cell_force", ctx["trace"], ctx["counts"],
                              ctx["dtype"])
