"""Device operations per step in the traced runs: what the host launches."""


def read(ctx, name):
    t = ctx["trace"]
    return t["device_ops"] / t["steps"]
