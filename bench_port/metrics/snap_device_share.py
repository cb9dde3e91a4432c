"""Percent of the traced runs' device busy time spent in SNAP's three step
kernels (snap_ui, snap_yi and snap_deidrj of the configuration's
`kernels`, read by name as `<kernel>_kernel` from the device trace):
whether SNAP does most of the cell's device work. The tally instances of
the thermo rows are not among the configuration's kernels and are left
out. None where the trace holds none of them."""

SNAP_KERNELS = ("snap_ui", "snap_yi", "snap_deidrj")


def read(ctx, name):
    traced = ctx["trace"]
    seen = [traced["kernels"][k]["total_s"] for k in SNAP_KERNELS
            if k in traced["kernels"]]
    if not seen or traced["busy_s"] <= 0:
        return None
    return 100.0 * sum(seen) / traced["busy_s"]
