"""Percent of the traced runs' wall time in which no device operation ran:
1 - (union of the device operations' intervals) / wall."""


def read(ctx, name):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
