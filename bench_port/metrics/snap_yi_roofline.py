"""Percent of its roofline one call of snap_yi reaches in the traced runs
(roofline/kernels/snap_yi.json; the end state's counts, pairs within the
overlay's cutoff and atoms)."""

from bench_port.roofline import peaks


def read(ctx, name):
    return peaks.kernel_share("snap_yi", ctx["trace"], ctx["counts"],
                              ctx["dtype"])
