"""Percent of the traced runs' device busy time spent in the
configuration's own kernels (its `kernels`, read by name as
`<kernel>_kernel` from the device trace): whether the Tersoff kernels do
most of the cell's device work. None where the trace holds none of them."""


def read(ctx, name):
    traced = ctx["trace"]
    seen = [traced["kernels"][k]["total_s"] for k in ctx["kernels"]
            if k in traced["kernels"]]
    if not seen or traced["busy_s"] <= 0:
        return None
    return 100.0 * sum(seen) / traced["busy_s"]
