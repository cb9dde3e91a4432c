"""Percent of its roofline one call of snap_deidrj reaches in the traced runs
(roofline/kernels/snap_deidrj.json; the end state's counts, pairs within the
overlay's cutoff and atoms)."""

from bench_port.roofline import peaks


def read(ctx, name):
    return peaks.kernel_share("snap_deidrj", ctx["trace"], ctx["counts"],
                              ctx["dtype"])
